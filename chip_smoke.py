"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main paths on the card and checks them:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written kernels (csrc/*.cu, one nvcc per
     source in parallel, sm_90a) and the host SA-IS oracle from this
     checkout's sources;
  3. kernels vs plain, exact, with both times (CUDA events, median of
     5): the pack kernel (K1) at the test shapes, in word mode (words
     0-2 one at a time and in one three-word launch, four packings,
     with and without minpad), at 2^28 bytes of random alnum and DNA as
     the doubling rank, and at 2^28 random alnum in five modes (word 0,
     word 1, a text view at an odd address, two words in one launch,
     and the refinement's pair table into the columns of pk2); K2 block_digit_sort and K3 place_runs at
     rbits 4 and 8, 2^16 and 2^28, uniform and 95%-skewed keys (the
     first design of the pass, which the sort no longer runs); the onesweep kernels
     digit_histograms and onesweep_pass at rbits 4 and 8, 2^16 and 2^28,
     uniform, skewed and constant keys, and one pass at 2^28 (3 and 4
     columns) timed beside K2 + glue + K3 and the plain pass; the radix
     sort at 2^28 on the real alnum key words, beside torch.sort, and at
     a refinement round's shape (segment, two window words and the
     positions; 28, 30 and 30 live bits) on 2^28 and 2^22 rows, with
     the passes it ran and skipped, and keys-only (the sharded
     carried-keys block: 2 or 3 alnum words and the tiebreak, 3 and 4
     columns, the 4-key histograms in two launches) on 2^27 rows;
  4. correctness: random alnum, DNA, period-1000 repetitive and words
     at 2^22 (the doubling route) and 2^24 (the direct route; words
     with device tie refinement) through build_suffix_array ->
     build_lcp_array -> LRS -> validator, against host SA-IS, Kasai and
     the LRS oracle, printing each route;
  5. full size, main path: the CLI's run() on 2^28 bytes of random alnum
     with validation, which must take the direct route, counting the
     kernels' launches; then the doubling builder plus PLCP on the same
     text, which must give the same SA and LCP byte for byte;
  6. the CLI's run() on 2^28 bytes of period-1000 text, validated, in
     chain mode on the direct route;
  7. the CLI's run() on 2^28 bytes of words (natural-text proxy),
     validated, on the direct route with refinement, counting the
     kernels' launches; then doubling plus PLCP on the same text, which
     must give the same SA and LCP byte for byte;
  8. the MSD bucket builder: (a) build_suffix_array_big at 2^24 on the
     four corpora of phase 4 (chunks of 2^22, buckets of 2^21: 4
     chunks, 8 or more buckets) against host SA-IS and Kasai; (b)
     build_sa_lcp on the 2^28 random alnum of phase 5 with the MSD
     forced (SA_DIRECT_CROSS=0) against the direct route, SA and LCP
     byte for byte, both timed warm; (c) the CLI's run() on 2^30 bytes
     of random alnum (made on the card from a seeded generator), which
     must take the MSD route, validate, and stay below the direct
     route's 56.00 GiB peak at 2^30 (PERF.md); its peak is then split
     into the build, the LRS and the validator (chunked, and the fused
     form for comparison), each phase after
     torch.cuda.reset_peak_memory_stats. Each MSD run counts the
     kernels' launches: K1, digit_histograms and onesweep_pass, and no
     K2 or K3;
  9. the CLI's run() on 2^31 - 1 bytes of random alnum (made on the
     card), validated by the chunked validator, on the MSD route, below
     80 GiB;
 10. the measurement path on the card: the micro benchmark at the quick
     sizes; the corpus harness in twin mode (corpora made on the card)
     over random, DNA, repetitive and words at 256 MB (direct route) and
     random at 1,024 MB (MSD), every row a success on platform cuda
     with the kernels' launches counted, the CSV read back with the
     harness's columns and the statistics report written; validated
     runs of words at 256 MB and random at 1,024 MB; one file-mode row
     on a 50 MB corpus file that this run writes, and the CLI's main()
     on the same file, whose output must parse to the same size and
     PATH;
 11. the device trace: one warm build_sa_lcp at 2^30 random alnum (MSD)
     and one at 2^28 words inside utils.profiling.device_trace; each
     trace must hold the onesweep pass and the K1 kernel by name; the
     ten device operations with the most time, the device's idle share
     of the window and its longest idle gaps are printed; then the
     CLI's main() with --trace on a small file;
 12. the sharded backend (parallel/), every shard on the one card: (a)
     build_suffix_array_sharded, build_lcp_array_sharded and
     is_valid_suffix_array_sharded on the four corpora of phase 4 at
     2^24 with P = 1, 2, 4 and 8 shards on the default routes (alnum,
     DNA and p1000 on the carried-keys builder, PATH sharded_msd, whose
     LCP the reroute above 8 MiB rebuilds; words may be refused and fall
     back to doubling) and, with P = 1 and 4, also with msd=False (the
     doubling builder and the distributed PLCP); against the SA-IS and
     Kasai arrays of
     phase 4, the validator rejecting a swapped pair and a duplicated
     entry, K1 launched exactly P times per carried-keys sort
     (pack_words) and per doubling build (pack_ranks), the onesweep sort
     launched and K2/K3 not; (b) the CLI's run() with backend "sharded"
     on 4 shards at 2^28 on phase 5's random alnum (made by the seeded
     host generator, so the arrays of phase 5 are the reference),
     validated, on PATH:sharded_msd (one carried-keys sort for SA and
     LCP), byte for byte equal to phase 5's single-device SA and LCP,
     with its peak and launches, then the distributed PLCP alone on its
     SA, timed; (c) bench/mesh_sweep.py at 16 MB random on one device
     and on 2, 4 and 8 shards: every row a success on platform cuda,
     parallel_results.csv with the harness's columns; (d)
     build_sa_lcp_sharded at 2^28 p1000 on 4 shards, in chain mode, byte
     for byte against phase 6's single-device arrays, timed, with its
     peak. The phase's wall time is printed;
 13. the multi-process path (cli_distributed.py, parallel/multihost.py,
     the _mp entry of parallel/bigsort.py), its workers started after
     the kernels are built, so they only load them: (a) the launcher
     ``--spawn 1 --devices-per-process 4`` on NCCL (a process group of
     one, four shards) on a 2^28 random alnum file holding phase 5's
     text: PATH:sharded_msd_mp, valid YES, the LRS of phase 5's arrays,
     and the worker's SA and LCP shards byte for byte equal to phase
     5's; (a') the library entry ``build_suffix_array_sharded_big_mp``
     in the same geometry through ``bench/weak_scaling_worker.py``: its
     shards equal to phase 5's arrays, and its launches equal to
     [12b]'s; (b) 2 processes x 2 shards sharing the card on gloo
     (``SA_PG_BACKEND=gloo``): 2^26 random alnum and 2^26 p1000 (chain
     mode) on PATH:sharded_msd_mp, byte for byte equal to the
     single-process sharded build of the same text, and 2^22 words,
     refused and built by PATH:sharded_doubling, equal to SA-IS and
     Kasai; (c) the weak-scaling runner (``bench/weak_scaling.py``) at
     2^24 bytes per shard, P = 1, 2, 4, 8 for its four builders and the
     two-process point, its CSV read back. Each worker resets and reports
     its own launch counts and peak; the workers' counts are summed. A
     worker that fails fails the smoke;
 14. the LCP routes (core/lcp_window.py) and the SA_CHAIN_MIN branch:
     (a) the CLI's run() at 6 MiB on random alnum, DNA, p1000 (made on
     the card) and words, each validated, its SA on the direct route and
     its SA and LCP equal to SA-IS and Kasai, the LCP on the sorted-fetch
     route (p1000: its misses closed by the chain rule; words: refused,
     then PLCP); then build_lcp_array on the same SA under
     SA_LCP_FETCH=sorted and =window, K1 launched once per three key
     words on the sorted fetch and never on the window route, and PLCP
     on the same SA, each timed once; (b) at
     2^28 random alnum (phase 5's text and SA) both routes against phase
     5's LCP byte for byte, warm median of 3, peak above the inputs, K1
     launches, PLCP on the same SA, and K1 alone at the route's shape
     (contiguous words and a row-major table) and the gather into SA
     order, each beside its bound; (c) with SA_BIG_THRESHOLD = 16 MiB,
     p1000 at 6 MiB on PATH:direct with (a)'s SA, alnum on
     PATH:doubling; (d) ``python -m hpc_suffix_array_tpu_torch banana``
     on the card;
 15. the headline benchmark: ``python3 bench_cuda.py`` at its defaults in
     a process of its own: one stdout line at 2^30 on the MSD route
     with no OOM fallback and the host SA-IS baseline, the six secondary
     metrics (sa_lcp_build, sa_build_dna, sa_build_repetitive_p1000,
     sa_build_words, lcp_build, lcp_build_sorted_fetch) each on its
     route with a positive value, words refined, and the kernels'
     launches the bench counted (K1, digit_histograms and onesweep_pass
     launched; K2 and K3 not); every metric line is printed, and the
     headline's build time beside [8c]'s CLI SA_TIME.

Phases 10 to 13 and 15 write under build/smoke.

The K1 launches of the CLI runs are checked exactly: one (two key
words) for 2^28 alnum, two (three key words, then the pair table) for
2^28 words, and 32 (one per chunk in the count pass and the scatter)
for 2^30 alnum.

Any failed phase raises and the script exits nonzero. The line before
the last is a JSON summary of the kernels, each row's ``launches`` read
from the words run of phase 7 (K2 and K3 read 0 there: the sort no
longer runs them; their ``check_launches`` are those of the one K2 +
glue + K3 pass of phase 3 that is held against the onesweep pass) and
its ``harness_launches`` from the twin sweep of phase 10, its
``sharded_launches`` from the sharded CLI run of phase 12b and its
``mp_launches`` from the multi-process CLI run of phase 13a (K1 also
its ``lcp_sorted_launches``, from the sorted-fetch LCP of phase 14b,
and its times at that shape) and its ``headline_launches`` from the
headline benchmark of phase 15, with
its bound: the larger of the bytes the timed call must move (each input
read once, each output written once) over 3.35 TB/s and its integer
operations over 67 T/s (the H100 SXM data sheet's HBM rate and its
non-tensor float32 rate, which the table gives in place of an int32
rate), and no library time (no single PyTorch call computes any of
these functions); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hpc_suffix_array_tpu_torch import (
    build_lcp_array, build_suffix_array, find_longest_repeated_substring,
    is_valid_suffix_array, native)
from hpc_suffix_array_tpu_torch.bench import (
    benchmark_corpora, run_benchmark, run_micro_benchmark)
from hpc_suffix_array_tpu_torch.bench.harness import _twin_for_file
from hpc_suffix_array_tpu_torch.bench.micro import CSV_HEADER
from hpc_suffix_array_tpu_torch.bench import mesh_sweep
from hpc_suffix_array_tpu_torch.bench.parse import parse_structured_results
from hpc_suffix_array_tpu_torch.bench import weak_scaling
from hpc_suffix_array_tpu_torch.cli import main as cli_main
from hpc_suffix_array_tpu_torch.cli import parse_args as cli_parse_args
from hpc_suffix_array_tpu_torch.cli import run as cli_run
from hpc_suffix_array_tpu_torch.cli_distributed import (
    run_distributed, run_workers, spawn)
from hpc_suffix_array_tpu_torch.core.bigsort import (
    build_suffix_array_big, direct_keys)
from hpc_suffix_array_tpu_torch.core.lcp import (
    build_sa_lcp, lcp_from_plcp, plcp_kernel)
from hpc_suffix_array_tpu_torch.core.lcp_window import (
    _pick_wn, build_lcp_array_sorted, build_lcp_array_window, prepare_lcp,
    prepare_lcp_sorted, sorted_words)
from hpc_suffix_array_tpu_torch.core.refine import (
    pair_table, refine_packing)
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap, as_byte_tensor, build_suffix_array_doubling)
from hpc_suffix_array_tpu_torch.core.validate import validate_kernel
from hpc_suffix_array_tpu_torch.datasets import (
    device_dna_text, device_random_text, device_repetitive_text,
    generate_dna_text, generate_random_text, generate_repetitive_text,
    generate_standard_datasets, generate_words_text,
    generate_words_text_batched)
from hpc_suffix_array_tpu_torch.kernels import (
    _build, launch_counts, reset_launch_counts)
from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference, pack_words, pack_words_reference)
from hpc_suffix_array_tpu_torch.kernels.radix import (
    LookBack, block_digit_sort, block_digit_sort_reference, digit_histograms,
    digit_histograms_reference, onesweep_pass, onesweep_pass_reference,
    place_runs, place_runs_reference, radix_pass, radix_sort_words,
    radix_sort_words_reference, run_offsets)
from hpc_suffix_array_tpu_torch.parallel import (
    build_lcp_array_sharded, build_sa_lcp_sharded, build_suffix_array_sharded,
    is_valid_suffix_array_sharded, make_mesh)
from hpc_suffix_array_tpu_torch.utils.profiling import (
    device_busy, device_trace, read_trace)
from hpc_suffix_array_tpu_torch.viz import generate_statistics_report

T0 = time.perf_counter()
FULL_N = 1 << 28
MSD_N = 1 << 30
MAX_N = (1 << 31) - 1
CHECK_SIZES = (1 << 22, 1 << 24)
# The card's peaks (H100 SXM data sheet): HBM
# bytes/s, and the float32 rate outside the tensor cores, which stands
# in for the int32 ALU rate the table does not give.
HBM_BPS = 3.35e12
ALU_OPS = 67e12
# Peak of the direct route at 2^30 random alnum, measured on one H100
# (PERF.md).
DIRECT_PEAK_2E30 = 56.00 * 2**30
CARD_BYTES = 80 * 2**30
SEED = 0
# Where phases 10 and 11 write (corpus file, CSVs, report, traces).
OUT_DIR = pathlib.Path("build/smoke")
# The twin sweep of phase 10: corpus name -> the route it must take.
TWIN_ROWS = {"random_256MB": "direct", "dna_256MB": "direct",
             "repetitive_256MB": "direct", "words_256MB": "direct",
             "random_1024MB": "msd"}
# The harness's CSV columns, in the JAX package's order.
HARNESS_COLUMNS = [
    "file", "size_bytes", "size_mb", "backend", "platform", "processes",
    "time_seconds", "throughput_mb_s", "throughput_chars_per_second",
    "lrs_length", "total_time", "sa_time", "lcp_time", "lrs_time",
    "compile_time", "builder", "success", "error", "timestamp", "input_mode"]
# (n, bits, h0) of the kernel tests, plus an n that is not a multiple of 128.
SMALL_CASES = [(128, 6, 5), (128 * 8, 3, 10), (128 * 9, 9, 3),
               (128 * 513, 6, 5), (1 << 17, 1, 30), (1000, 6, 5)]
# (bits, spw) of the carried-keys packings, and word-mode lengths (the
# last is not a multiple of the 4096-position tile).
WORD_CASES = [(6, 5), (2, 15), (1, 30), (8, 3)]
WORD_SIZES = [1000, 128 * 513, 4096 * 3 + 5]
REFINE_KEYS = ("refine_members", "refine_pieces", "refine_rounds",
               "refine_host_members", "refine_phase_s")
# Phase 12, the sharded backend: the meshes (all on the one card) at
# 2^24, the full-size CLI run's mesh, and the mesh sweep's corpus size.
SHARDS = (1, 2, 4, 8)
# The meshes of [12a] that also run the doubling builder and the
# distributed PLCP (msd=False), the slowest of the phase's routes.
PLCP_SHARDS = (1, 4)
SHARDED_N = 1 << 24
SHARDED_P = 4
SWEEP_MB = 16
# Phase 13, the multi-process path: shards per process of the NCCL run,
# the gloo runs' text sizes, and the weak-scaling runner's bytes per
# shard.
MP_DPP = 4
MP_N = 1 << 26
MP_WORDS_N = 1 << 22
WEAK_BYTES = 1 << 24
WEAK_BUILDERS = {"msd": 4, "msd_lcp": 4, "msd_wide": 4, "doubling": 4,
                 "msd_2proc": 2}
# Phase 14, the LCP routes: the text size of [14a] and [14c] (between
# SA_LCP_WINDOW_MIN and SA_LCP_BIG_MIN), the LCP route and miss finish
# each corpus must take there (words: the sorted fetch refuses, then
# PLCP), and the SA_BIG_THRESHOLD of [14c], above that size.
LCP_N = 6 << 20
LCP_ROUTES = {"random alnum": ("sorted", "none"), "DNA": ("sorted", "none"),
              "repetitive p1000": ("sorted", "chain"),
              "words": ("plcp", None)}
CHAIN_BIG = 1 << 24
# Phase 15, the headline benchmark (bench_cuda.py at its defaults): each
# secondary metric, the key that names its route and the route it must
# take at 2^30 (DNA and the LCP metrics at 2^28).
HEADLINE_ROUTES = {
    "sa_lcp_build": ("path", "msd_bigsort_want_lcp"),
    "sa_build_dna": ("path", "direct_sort"),
    "sa_build_repetitive_p1000": ("path", "msd_chain"),
    "sa_build_words": ("path", "msd_bigsort"),
    "lcp_build": ("lcp_path", "direct"),
    "lcp_build_sorted_fetch": ("path", "sorted_fetch_standalone"),
}
CORPORA = (("random alnum", generate_random_text),
           ("DNA", generate_dna_text),
           ("repetitive p1000", generate_repetitive_text),
           ("words", generate_words_text))


def phase(msg: str) -> None:
    """Prints a phase's line with the seconds since the script began."""
    print(f"{msg} [{time.perf_counter() - T0:.0f} s]", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 5, setup=None) -> float:
    """Median device time of ``fn(setup())`` in ms (CUDA events, after a
    warm-up); ``setup`` runs outside the timed window."""
    setup = setup or (lambda: None)
    fn(setup())
    times = []
    for _ in range(reps):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> int:
    """Max absolute difference of two tensors or lists of tensors."""
    if isinstance(got, (list, tuple)):
        return max(max_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def exact(got, want, what: str) -> int:
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err != 0:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max abs err {err}")
    return err


def bound(n_bytes: float, ops: float) -> dict:
    """bound_ms and bound_by of a call that moves ``n_bytes`` and does
    ``ops`` integer operations."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = ops / ALU_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def alnum_on_card(n: int, seed: int) -> np.ndarray:
    """Random alnum bytes made on the card, copied to the host once."""
    return device_random_text(n, seed, "cuda").cpu().numpy()


def compare_pack(text: np.ndarray, remap: np.ndarray, bits: int, h0: int,
                 n_real: int, offset: int = 0, timed: bool = False) -> dict:
    t = torch.tensor(text, dtype=torch.uint8, device="cuda")
    r = torch.tensor(remap, dtype=torch.int32, device="cuda")
    err = exact(pack_ranks(t, r, bits, h0, n_real, offset),
                pack_ranks_reference(t, r, bits, h0, n_real, offset),
                f"pack n={len(text)} bits={bits} h0={h0} offset={offset}")
    out = {"max_abs_err": err}
    if timed:
        out["ms"] = median_ms(
            lambda _: pack_ranks(t, r, bits, h0, n_real, offset))
        out["plain_ms"] = median_ms(
            lambda _: pack_ranks_reference(t, r, bits, h0, n_real, offset))
    return out


def compare_words(text: np.ndarray, table: np.ndarray, bits: int, spw: int,
                  n_words: int, offset: int = 0) -> None:
    """pack_words (n_words in one launch) against its plain version."""
    t = torch.tensor(text, dtype=torch.uint8, device="cuda")
    r = torch.tensor(table, dtype=torch.int32, device="cuda")
    n = len(text)
    for n_real, n_out in ((n, n), (n - 3, n - offset - 1)):
        exact(pack_words(t, r, bits, spw, n_real, n_words, offset,
                         max(n_out, 0)),
              pack_words_reference(t, r, bits, spw, n_real, n_words, offset,
                                   max(n_out, 0)),
              f"pack_words n={n} bits={bits} spw={spw} words={n_words} "
              f"offset={offset}")


def k1_modes(text: np.ndarray, words: np.ndarray) -> dict:
    """K1 at 2^28 in five modes, each exact against pack_words_reference
    and timed beside it: word 0, word 1 (offset spw), a text view at an
    odd address, two words in one launch (random alnum, bits 6, spw 5),
    and the refinement's pair table on the words text (two words into
    the columns of pk2)."""
    t = torch.tensor(text, dtype=torch.uint8, device="cuda")
    remap, _, _ = alphabet_remap(text)
    tab = torch.tensor(remap, dtype=torch.int32, device="cuda")
    n = len(text)
    view = t[3:]
    modes = {
        "word0": (t, 1, 0),
        "word1": (t, 1, 5),
        "view3": (view, 1, 0),
        "two_words": (t, 2, 0),
    }
    out = {}
    for name, (tt, nw, off) in modes.items():
        m = tt.shape[0]

        def kern(_, tt=tt, nw=nw, off=off, m=m):
            return pack_words(tt, tab, 6, 5, m, nw, off)

        def plain(_, tt=tt, nw=nw, off=off, m=m):
            return pack_words_reference(tt, tab, 6, 5, m, nw, off)

        err = exact(kern(None), plain(None), f"K1 2^28 {name}")
        out[name] = {"max_abs_err": err, "ms": median_ms(kern),
                     "plain_ms": median_ms(plain), "rows": m,
                     "n_words": nw}
    del t, view
    tw = torch.tensor(words, dtype=torch.uint8, device="cuda")
    wremap, _, _ = alphabet_remap(words)
    bits, spw = refine_packing(int(wremap.max()))
    wtab = torch.tensor(wremap, dtype=torch.int32, device="cuda")
    pk2 = pair_table(tw, wremap)
    cols = [torch.empty(n, dtype=torch.int32, device="cuda")
            for _ in range(2)]
    err = exact([pk2[:n, 0], pk2[:n, 1]],
                pack_words_reference(tw, wtab, bits, spw, n, 2, out=cols),
                "K1 2^28 pk2")
    if pk2[n].any():
        raise AssertionError("pk2's all-pad row is not 0")
    out["pk2"] = {
        "max_abs_err": err, "rows": n, "n_words": 2,
        "ms": median_ms(lambda _: pair_table(tw, wremap)),
        "plain_ms": median_ms(lambda _: pack_words_reference(
            tw, wtab, bits, spw, n, 2, out=[pk2[:n, 0], pk2[:n, 1]]))}
    return out


def keys_on_card(kind: str, n: int, seed: int) -> list[torch.Tensor]:
    """(key, iota, second key) int32 columns: uniform 30-bit keys, the
    TestRadix skew (95% of keys 15 << 8), or one constant key (every
    tile on one digit: the longest look-back chains)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    key = torch.randint(0, 1 << 30, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    if kind == "skewed":
        hot = torch.rand(n, generator=g, device="cuda") < 0.95
        key = torch.where(hot, torch.full_like(key, 15 << 8), key)
    elif kind == "constant":
        key = torch.full_like(key, 0x2A5A5A5A)
    other = torch.randint(0, 1 << 30, (n,), generator=g, device="cuda",
                          dtype=torch.int32)
    return [key, torch.arange(n, dtype=torch.int32, device="cuda"), other]


def compare_radix_pass(n: int, rbits: int, kind: str, timed: bool) -> dict:
    """K2, the glue and K3 against their plain versions on one pass."""
    cols = keys_on_card(kind, n, n + rbits)
    shift = 8
    staged, hist = block_digit_sort(cols, 0, shift, rbits)
    want_staged, want_hist = block_digit_sort_reference(cols, 0, shift,
                                                        rbits)
    what = f"n={n} rbits={rbits} {kind}"
    err2 = max(exact(staged, want_staged, "block_digit_sort " + what),
               exact(hist, want_hist, "block_digit_sort hist " + what))
    del want_staged, want_hist
    offs = run_offsets(hist)
    placed = place_runs(staged, 0, shift, rbits, *offs)
    err3 = exact(placed, place_runs_reference(staged, 0, shift, rbits,
                                              *offs),
                 "place_runs " + what)
    digits = (cols[0] >> shift) & ((1 << rbits) - 1)
    order = torch.sort(digits, stable=True).indices
    exact(placed, [c[order] for c in cols], "radix pass order " + what)
    del digits, order, placed
    out = {"k2_err": err2, "k3_err": err3}
    if timed:
        out["k2_ms"] = median_ms(
            lambda _: block_digit_sort(cols, 0, shift, rbits, staged))
        out["k2_plain_ms"] = median_ms(
            lambda _: block_digit_sort_reference(cols, 0, shift, rbits))
        dst = [torch.empty_like(c) for c in cols]
        out["k3_ms"] = median_ms(
            lambda _: place_runs(staged, 0, shift, rbits, *offs, out=dst))
        out["k3_plain_ms"] = median_ms(
            lambda _: place_runs_reference(staged, 0, shift, rbits, *offs,
                                           out=dst))
    return out


def plain_starts(key: torch.Tensor, shift: int, rbits: int) -> torch.Tensor:
    """digit_starts of one onesweep_pass outside a sort: the exclusive
    scan of the plain digit counts."""
    digit = ((key.long() & 0xFFFFFFFF) >> shift) & ((1 << rbits) - 1)
    hist = torch.bincount(digit, minlength=1 << rbits)
    return (torch.cumsum(hist, 0) - hist).to(torch.int32)


def compare_onesweep(n: int, rbits: int, kind: str) -> dict:
    """digit_histograms (the key and the second key as two 30-bit words)
    and one onesweep_pass against their plain versions."""
    cols = keys_on_card(kind, n, n + rbits + 1)
    words = [cols[0], cols[2]]
    what = f"n={n} rbits={rbits} {kind}"
    err_h = exact(digit_histograms(words, 30, rbits),
                  digit_histograms_reference(words, 30, rbits),
                  "digit_histograms " + what)
    err_p = 0
    for shift in (0, 30 - rbits):
        err_p = max(err_p, exact(
            onesweep_pass(cols, 0, shift, rbits,
                          plain_starts(cols[0], shift, rbits),
                          LookBack(n, 1, "cuda")),
            onesweep_pass_reference(cols, 0, shift, rbits),
            f"onesweep_pass shift={shift} " + what))
    return {"hist_err": err_h, "pass_err": err_p}


def time_passes(n_cols: int) -> dict:
    """One pass at 2^28, rbits 8, shift 8, on ``n_cols`` int32 columns:
    onesweep_pass (its digit starts given, its look-back status zeroed
    in each call), the K2 + glue + K3 pass and the plain pass. The K2 +
    glue + K3 pass runs once first, against the onesweep pass's output,
    with the launch counts set to 0 just before it."""
    cols = keys_on_card("uniform", FULL_N, 8)
    if n_cols == 4:
        cols.append(cols[2].flip(0))
    hist = digit_histograms([cols[0]], 16, 8)[1]
    starts = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    out = [torch.empty_like(c) for c in cols]

    def one_pass(lookback):
        onesweep_pass(cols, 0, 8, 8, starts, lookback, out)

    def fresh_lookback():
        return LookBack(FULL_N, 1, "cuda")

    one_pass(fresh_lookback())
    work = [c.clone() for c in cols]
    staging = [torch.empty_like(c) for c in cols]
    block_digit_sort.launches = place_runs.launches = 0
    radix_pass(work, 0, 8, 8, staging)
    k23_launches = {"block_digit_sort": block_digit_sort.launches,
                    "place_runs": place_runs.launches}
    exact(work, out, f"K2 + glue + K3 pass vs onesweep pass, {n_cols} cols")
    return {"ms": median_ms(one_pass, setup=fresh_lookback),
            "k23_ms": median_ms(
                lambda _: radix_pass(work, 0, 8, 8, staging),
                setup=lambda: [w.copy_(c) for w, c in zip(work, cols)]),
            "plain_ms": median_ms(
                lambda _: onesweep_pass_reference(cols, 0, 8, 8, out)),
            "k23_launches": k23_launches}


def sort_and_count(words, payload, live):
    """radix_sort_words, and the passes it ran and skipped."""
    run0 = radix_sort_words.passes_run
    skip0 = radix_sort_words.passes_skipped
    got = radix_sort_words(words, payload, live)
    return got, (radix_sort_words.passes_run - run0,
                 radix_sort_words.passes_skipped - skip0)


def compare_sort(text: np.ndarray) -> dict:
    """radix_sort_words on the 2^28 alnum key words (k0, k1) against its
    plain version, and both beside torch.sort on the same 60-bit key;
    digit_histograms on the two words against its plain version."""
    t = torch.tensor(text, dtype=torch.uint8, device="cuda")
    remap, _, _ = alphabet_remap(text)
    words = direct_keys(t, remap, 6, 5, 2, False)
    del t
    idx = torch.arange(len(text), dtype=torch.int32, device="cuda")

    def fresh():
        return [w.clone() for w in words], idx.clone()

    got, passes = sort_and_count(*fresh(), 30)
    err = exact(got, radix_sort_words_reference(*fresh(), 30),
                "radix_sort_words 2^28 alnum")
    del got
    hist_err = exact(digit_histograms(words, 30),
                     digit_histograms_reference(words, 30),
                     "digit_histograms 2^28 alnum key words")

    def composite(_):
        key = (words[0].long() << 30) | words[1].long()
        return idx[torch.sort(key, stable=True).indices]

    return {"max_abs_err": err, "passes": passes, "hist_err": hist_err,
            "hist_ms": median_ms(lambda _: digit_histograms(words, 30)),
            "hist_plain_ms": median_ms(
                lambda _: digit_histograms_reference(words, 30)),
            "ms": median_ms(lambda a: radix_sort_words(*a, 30),
                            setup=fresh),
            "plain_ms": median_ms(
                lambda a: radix_sort_words_reference(*a, 30), setup=fresh),
            "torch_sort_ms": median_ms(composite)}


def compare_keys_only_sort(text: np.ndarray, n: int, nw: int) -> dict:
    """radix_sort_words keys-only, the sharded carried-keys builder's
    block: ``nw`` alnum key words (31 live bits, as the builder reads
    them beside PAD_KEY) and the unique tiebreak, no payload, on ``n``
    rows; four keys count their histograms in two launches."""
    t = torch.tensor(text[:n], dtype=torch.uint8, device="cuda")
    remap, _, _ = alphabet_remap(text[:n])
    keys = direct_keys(t, remap, 6, 5, nw, False)
    del t
    keys.append(torch.arange(n, dtype=torch.int32, device="cuda").flip(0))
    live = [31] * nw + [max(1, (n - 1).bit_length())]

    def fresh():
        return [k.clone() for k in keys]

    before = digit_histograms.launches
    (got, _), passes = sort_and_count(fresh(), None, live)
    hist_launches = digit_histograms.launches - before
    err = exact(got, radix_sort_words_reference(fresh(), None, live)[0],
                f"keys-only radix_sort_words, {nw + 1} keys, n={n}")
    del got
    return {"max_abs_err": err, "passes": passes,
            "hist_launches": hist_launches,
            "ms": median_ms(lambda a: radix_sort_words(a, None, live),
                            setup=fresh),
            "plain_ms": median_ms(
                lambda a: radix_sort_words_reference(a, None, live),
                setup=fresh)}


def compare_refine_sort(n: int) -> dict:
    """radix_sort_words at a refinement round's shape: a non-decreasing
    segment word (28 live bits), two heavily tied 30-bit window words
    and the positions, against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(n)
    iota = torch.arange(n, dtype=torch.int32, device="cuda")
    head = torch.rand(n, generator=g, device="cuda") < 0.3
    head[0] = True
    seg = torch.cummax(torch.where(head, iota, -1), 0).values
    words = [seg] + [
        (torch.randint(0, 40, (n,), generator=g, device="cuda",
                       dtype=torch.int32) << 24)
        | torch.randint(0, 3, (n,), generator=g, device="cuda",
                        dtype=torch.int32) for _ in range(2)]
    live = [28, 30, 30]

    def fresh():
        return [w.clone() for w in words], iota.clone()

    got, passes = sort_and_count(*fresh(), live)
    err = exact(got, radix_sort_words_reference(*fresh(), live),
                f"radix_sort_words refinement shape n={n}")
    del got
    return {"max_abs_err": err, "passes": passes,
            "ms": median_ms(lambda a: radix_sort_words(*a, live),
                            setup=fresh),
            "plain_ms": median_ms(
                lambda a: radix_sort_words_reference(*a, live),
                setup=fresh)}


def check_corpus(name: str, text: np.ndarray):
    """SA, LCP, LRS and validator on the card against the host oracles;
    returns (route, SA-IS array, Kasai array)."""
    t0 = time.perf_counter()
    info: dict = {}
    text_dev = as_byte_tensor(text, "cuda")
    sa = build_suffix_array(text, device="cuda", info=info,
                            text_dev=text_dev)
    lcp = build_lcp_array(text, sa, device="cuda", info=info,
                          text_dev=text_dev)
    lrs = find_longest_repeated_substring(text_dev, sa, lcp, device="cuda")
    valid = is_valid_suffix_array(text_dev, sa, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want_sa = native.sa_build(text)
    if not np.array_equal(sa.cpu().numpy(), want_sa):
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
    if is_valid_suffix_array(text_dev, bad, device="cuda"):
        raise AssertionError(f"{name}: validator accepted a swapped pair")
    route = {k: info.get(k) for k in ("path", "lcp_path", "rerun",
                                      "chain_mode", "n_words", "rounds",
                                      "plcp_rounds", "declined")
             + REFINE_KEYS}
    phase(f"[4] {name} n={len(text)}: SA == SA-IS, LCP == Kasai, LRS "
          f"length {len(lrs or b'')} == oracle, validator True/False ok; "
          f"route {json.dumps(route)}; device pipeline {dt:.3f} s")
    return route, want_sa, want_lcp


MAIN_PATH_KERNELS = ("pack_words", "digit_histograms", "onesweep_pass")
SPLIT_PASS_KERNELS = ("block_digit_sort", "place_runs")


def reset_launches() -> None:
    reset_launch_counts()
    radix_sort_words.passes_run = radix_sort_words.passes_skipped = 0


launches = launch_counts


def passes() -> dict:
    return {"passes_run": radix_sort_words.passes_run,
            "passes_skipped": radix_sort_words.passes_skipped}


def check_launches(counts: dict, name: str) -> None:
    """The main-path kernels ran, K2 and K3 did not."""
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name}: main path launched no {missing}")
    old = [k for k in SPLIT_PASS_KERNELS if counts[k]]
    if old:
        raise AssertionError(f"{name}: main path launched {old}")


def k1_bound(r: dict) -> dict:
    """K1's bound: each text byte read once, each int32 word written
    once; spw = 5 shift-ors per word and row."""
    rows, nw = r["rows"], r["n_words"]
    return bound(rows + 4 * nw * rows + 256 * 4, 2 * 5 * nw * rows)


def run_cli(text: np.ndarray, name: str, arrays: dict | None = None,
            path: str = "direct", k1: int | None = None):
    """cli.run with validation on route ``path``; returns (results,
    launches, peak bytes). Fails if the build took another route or, with
    ``k1``, launched K1 another number of times."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_launches()
    res = cli_run(text, name, "cuda", validate=True, dialect="sequential",
                  out=buf, arrays=arrays)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    report = buf.getvalue()
    if "Valid suffix array: YES" not in report:
        raise AssertionError(f"{name} not validated:\n" + report)
    if f"PATH:{path}\n" not in report or res.get("path") != path:
        raise AssertionError(f"{name} did not take the {path} route:\n"
                             + report)
    check_launches(counts, name)
    if k1 is not None and (counts["pack_words"], counts["pack_ranks"]) != (
            k1, 0):
        raise AssertionError(f"{name}: K1 launched {counts['pack_words']} "
                             f"+ {counts['pack_ranks']} times, not {k1}")
    counts.update(passes())
    return res, counts, peak


def peak_split(text: np.ndarray) -> dict:
    """The CLI's phases on ``text`` one by one, as ``cli.run`` runs them
    above 8 MiB, with the peak reset before each: the fused SA+LCP
    build, the LRS, the validator as the CLI calls it, and the fused
    validator for comparison (GiB, and seconds on the host clock)."""
    out = {}

    def step(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[name] = {"peak_gib": round(
            torch.cuda.max_memory_allocated() / 2**30, 2),
            "s": round(time.perf_counter() - t0, 3)}
        return got

    torch.cuda.empty_cache()
    t = step("staging", lambda: as_byte_tensor(text, "cuda"))
    sa, lcp = step("build_sa_lcp", lambda: build_sa_lcp(
        text, device="cuda", text_dev=t))
    step("lrs", lambda: find_longest_repeated_substring(t, sa, lcp,
                                                        device="cuda"))
    ok = step("validate", lambda: is_valid_suffix_array(t, sa,
                                                        device="cuda"))
    fused = step("validate_fused", lambda: bool(validate_kernel(t, sa)))
    if not (ok and fused):
        raise AssertionError("peak split: the validator rejected the SA")
    return out


def against_doubling(text: np.ndarray, arrays: dict, tag: str, name: str,
                     card: str) -> None:
    """The doubling route and PLCP on the same text: an independent
    device route, held byte for byte against the CLI's SA and LCP."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text_dev = as_byte_tensor(text, "cuda")
    info: dict = {}
    sa = build_suffix_array_doubling(text_dev, device="cuda", info=info)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plcp, plcp_rounds = plcp_kernel(text_dev, sa)
    lcp = lcp_from_plcp(plcp, sa)
    del plcp
    find_longest_repeated_substring(text_dev, sa, lcp, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    if pack_ranks.launches < 1:
        raise AssertionError("doubling route launched no pack kernel")
    if not (torch.equal(sa, arrays["sa"]) and
            torch.equal(lcp, arrays["lcp"])):
        raise AssertionError(f"2^28 {name}: direct and doubling+PLCP "
                             "routes differ")
    phase(f"{tag} doubling + PLCP n=2^28 {name}: SA and LCP == the "
          f"direct route's, byte for byte; rounds={info['rounds']} "
          f"plcp_rounds={plcp_rounds}; SA {t1 - t0:.3f} s, LCP+LRS "
          f"{t2 - t1:.3f} s, total {t2 - t0:.3f} s; peak "
          f"{peak / 2**30:.2f} GiB; pack launches {pack_ranks.launches} "
          f"({card})")


def msd_at_2e24(oracles: dict, card: str) -> None:
    """[8a] build_suffix_array_big at 2^24 on the four corpora of phase
    4, with 4 chunks and 8 or more buckets, against SA-IS and Kasai."""
    for name, gen in CORPORA:
        text = gen(CHECK_SIZES[-1], SEED)
        want_sa, want_lcp = oracles[name]
        info: dict = {}
        reset_launches()
        sa, lcp = build_suffix_array_big(
            text, device="cuda", info=info, want_lcp=True,
            chunk_elems=1 << 22, target_bucket=1 << 21)
        counts = launches()
        if not (np.array_equal(sa.cpu().numpy(), want_sa)
                and np.array_equal(lcp.cpu().numpy(), want_lcp)):
            raise AssertionError(f"MSD 2^24 {name}: SA or LCP differs "
                                 "from SA-IS/Kasai")
        if info["n_buckets_run"] < 8:
            raise AssertionError(f"MSD 2^24 {name}: only "
                                 f"{info['n_buckets_run']} buckets")
        check_launches(counts, f"MSD 2^24 {name}")
        keep = {k: info.get(k) for k in (
            "n_buckets_run", "chain_mode", "periods", "n_patched", "rerun",
            "refine_members", "phase_device_ms")}
        phase(f"[8a] MSD n=2^24 {name}, 4 chunks: SA == SA-IS, LCP == "
              f"Kasai; {json.dumps(keep)}; launches {json.dumps(counts)} "
              f"({card})")


def msd_against_direct(text: np.ndarray, card: str) -> None:
    """[8b] build_sa_lcp on 2^28 random alnum with the MSD forced
    (SA_DIRECT_CROSS=0) against the direct route: SA and LCP byte for
    byte, each timed warm in the order direct, MSD, MSD, direct."""
    t = as_byte_tensor(text, "cuda")
    ms = {"direct": [], "msd": []}
    out, counts = {}, None
    for cross in (None, "0", None, "0", "0", None):
        if cross is None:
            os.environ.pop("SA_DIRECT_CROSS", None)
        else:
            os.environ["SA_DIRECT_CROSS"] = cross
        info: dict = {}
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_now = build_sa_lcp(text, device="cuda", info=info, text_dev=t)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        want = "direct" if cross is None else "msd"
        if info["path"] != want:
            raise AssertionError(f"2^28 alnum took {info['path']}, not "
                                 f"{want}")
        if want == "msd":
            counts = launches()
            check_launches(counts, "MSD 2^28 alnum")
        if want in out:
            ms[want].append(dt)       # the first run of each is a warm-up
        out[want] = out_now
    os.environ.pop("SA_DIRECT_CROSS", None)
    if not (torch.equal(out["msd"][0], out["direct"][0])
            and torch.equal(out["msd"][1], out["direct"][1])):
        raise AssertionError("2^28 alnum: MSD and direct SA+LCP differ")
    phase(f"[8b] build_sa_lcp n=2^28 random alnum, MSD forced: SA and LCP "
          f"== the direct route's, byte for byte; warm ms direct "
          f"{[round(x, 2) for x in ms['direct']]}, MSD "
          f"{[round(x, 2) for x in ms['msd']]}; MSD launches "
          f"{json.dumps(counts)} ({card})")


def row_times(row: dict) -> str:
    return (f"total {row['total_time']:.4f} s (SA {row['sa_time']:.4f}, LCP "
            f"{row['lcp_time']:.4f}, LRS {row['lrs_time']:.4f}), first-use "
            f"{row['compile_time']:.4f} s, {row['throughput_mb_s']:.1f} MB/s")


def harness_on_card(card: str) -> dict:
    """[10] the micro benchmark, the twin sweep, two validated runs and
    one file-mode row against the CLI; returns the twin sweep's launch
    counts."""
    results = run_micro_benchmark(
        out_csv=OUT_DIR / "micro_results.csv", sizes=(1_000, 10_000, 100_000),
        reps=1, device="cuda", verbose=False)
    with open(OUT_DIR / "micro_results.csv", newline="") as f:
        micro = list(csv.reader(f))
    if micro[0] != CSV_HEADER or len(micro) != 7 or any(
            r.implementation != "cuda" or r.sa_time <= 0 for r in results):
        raise AssertionError(f"micro benchmark: {micro}")
    phase(f"[10] micro benchmark, 6 rows on cuda: total s "
          f"{[round(r.total_time, 5) for r in results]} ({card})")

    reset_launches()
    rows = benchmark_corpora(
        list(TWIN_ROWS), results_dir=OUT_DIR, device="cuda", verbose=False,
        seq_csv_name="sequential_results_twin.csv", twin=True)
    counts = launches()
    check_launches(counts, "twin sweep")
    for row, (name, path) in zip(rows, TWIN_ROWS.items()):
        want = {"file": name, "success": True, "platform": "cuda",
                "backend": "cuda_twin", "input_mode": "twin_device",
                "builder": path}
        got = {k: row.get(k) for k in want}
        if got != want or row["sa_time"] <= 0 or row["lrs_length"] <= 0:
            raise AssertionError(f"twin row {name}: {row}")
        phase(f"[10] twin {name}: builder {row['builder']}, LRS "
              f"{row['lrs_length']}, {row_times(row)} ({card})")
    twin_csv = OUT_DIR / "sequential_results_twin.csv"
    with open(twin_csv, newline="") as f:
        reader = csv.DictReader(f)
        read_back = list(reader)
        if reader.fieldnames != HARNESS_COLUMNS:
            raise AssertionError(f"CSV columns {reader.fieldnames}")
    if [r["file"] for r in read_back] != list(TWIN_ROWS):
        raise AssertionError(f"CSV rows {read_back}")
    report = generate_statistics_report(
        twin_csv, OUT_DIR / "performance_statistics.txt")
    if "fitted exponent" not in report.read_text():
        raise AssertionError("statistics report:\n" + report.read_text())
    phase(f"[10] twin sweep: 5 rows, CSV read back with the harness's 20 "
          f"columns, {report} written; launches {json.dumps(counts)}")

    # benchmark_corpora has no validation switch: validate two rows here.
    for name in ("words_256MB", "random_1024MB"):
        text, text_dev = _twin_for_file(name, "cuda")
        r = run_benchmark(text, device="cuda", validate=True, warmup=False,
                          text_dev=text_dev)
        if r.valid is not True or r.builder != TWIN_ROWS[name]:
            raise AssertionError(f"validated run {name}: {r}")
        phase(f"[10] run_benchmark {name}, validate=True: valid True, "
              f"builder {r.builder}, total {r.total_time:.4f} s ({card})")
        del text, text_dev
        torch.cuda.empty_cache()

    (path,) = generate_standard_datasets(
        OUT_DIR / "data", random_mb=(50,), repetitive_mb=(), dna_mb=())
    (row,) = benchmark_corpora([path], results_dir=OUT_DIR, device="cuda",
                               verbose=False)
    if not row["success"] or (row["input_mode"], row["backend"]) != (
            "file", "cuda"):
        raise AssertionError(f"file row: {row}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(path)])
    rec = parse_structured_results(buf.getvalue())
    if rc != 0 or row["size_bytes"] != 50 << 20 or (
            rec.get("file_size"), rec.get("path")) != (
            row["size_bytes"], row["builder"]):
        raise AssertionError(f"file row {row} vs CLI {rec} (exit {rc})")
    phase(f"[10] file {path.name}: harness row builder {row['builder']}, "
          f"{row_times(row)}; cli.main parses to FILE_SIZE "
          f"{rec['file_size']}, PATH {rec['path']}, SA_TIME "
          f"{rec['sa_time']:.4f} s, TOTAL_TIME {rec['total_time']:.4f} s "
          f"({card})")
    return counts


def traced_build(name: str, want_path: str, card: str) -> None:
    """[11] one warm build_sa_lcp on the twin corpus ``name`` inside
    device_trace: the trace must hold the main-path kernels by name."""
    text, text_dev = _twin_for_file(name, "cuda")
    # The warm-up's blocks stay in the caching allocator, so the traced
    # build's window holds no cudaMalloc.
    build_sa_lcp(text, device="cuda", text_dev=text_dev)
    trace_dir = OUT_DIR / f"trace_{name}"
    info: dict = {}
    with device_trace(trace_dir, "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build_sa_lcp(text, device="cuda", info=info, text_dev=text_dev)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    del out
    if info["path"] != want_path:
        raise AssertionError(f"traced {name} took {info['path']}")
    events = read_trace(trace_dir)
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    for needle in ("onesweep_pass", "pack_words", "digit_histograms"):
        if not any(needle in k for k in kernels):
            raise AssertionError(f"trace of {name} holds no {needle} "
                                 f"kernel: {sorted(kernels)[:40]}")
    busy = device_busy(events)
    size = (trace_dir / "trace.json").stat().st_size
    phase(f"[11] trace {name} ({info['path']}): build under the profiler "
          f"{traced_s:.3f} s; {busy['n_events']} device events, window "
          f"{busy['window_ms']:.1f} ms, busy {busy['busy_ms']:.1f} ms, idle "
          f"share {busy['idle_share']:.3f}; trace {size / 2**20:.1f} MiB "
          f"({card})")
    phase(f"[11] trace {name} top device operations: "
          f"{json.dumps(busy['top'])}")
    phase(f"[11] trace {name} longest idle gaps: {json.dumps(busy['gaps'])}")
    del text, text_dev
    torch.cuda.empty_cache()


def cli_trace(path) -> None:
    """[11] the CLI's --trace on a file."""
    trace_dir = OUT_DIR / "trace_cli"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(path), "--trace", str(trace_dir)])
    if rc != 0 or f"device trace written to {trace_dir}" not in (
            buf.getvalue()) or not (trace_dir / "trace.json").exists():
        raise AssertionError(f"cli --trace (exit {rc}):\n" + buf.getvalue())
    phase(f"[11] cli.main {path} --trace: device trace written to "
          f"{trace_dir}")


def sharded_counts() -> dict:
    return {**launches(), **passes()}


@contextlib.contextmanager
def env(**values):
    """The environment variables ``values`` for the block's duration."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# Raised for the runs that must take the distributed PLCP, not the
# carried-keys LCP (the reroute above SA_LCP_BIG_MIN).
PLCP_ONLY = {"SA_LCP_BIG_MIN": 1 << 40}


def check_sharded_launches(counts: dict, n_shards: int, name: str,
                           path: str, sorts: int) -> None:
    """A sharded build launches K1 once per shard and attempt: each
    carried-keys sort (``sorts``, refused ones included) packs its key
    words (``pack_words``), and the doubling fallback its ranks
    (``pack_ranks``, on path sharded_doubling); both sort on the
    onesweep kernels, and nothing launches K2 or K3."""
    want = (n_shards * sorts,
            n_shards if path == "sharded_doubling" else 0)
    if (counts["pack_words"], counts["pack_ranks"]) != want:
        raise AssertionError(f"{name} ({path}, {sorts} carried-keys "
                             f"sorts): K1 launched {counts['pack_words']} "
                             f"+ {counts['pack_ranks']} times, not {want}")
    if counts["digit_histograms"] < 1 or counts["onesweep_pass"] < 1:
        raise AssertionError(f"{name}: the onesweep sort did not run: "
                             f"{counts}")
    if counts["block_digit_sort"] or counts["place_runs"]:
        raise AssertionError(f"{name}: launched K2/K3: {counts}")


def sharded_corpus(name: str, text: np.ndarray, want_sa: np.ndarray,
                   want_lcp: np.ndarray, n_shards: int, card: str,
                   msd: bool | None) -> dict:
    """[12a] the sharded SA, LCP and validator on ``n_shards`` shards of
    the one card, against SA-IS and Kasai; the validator must reject a
    swapped pair and a duplicated entry. ``msd`` None: the default
    routes (the carried keys from 4 MiB, and the LCP's carried-keys
    reroute above 8 MiB); False: the doubling builder and the
    distributed PLCP."""
    mesh = make_mesh(n_shards, devices=["cuda:0"])
    text_dev = as_byte_tensor(text, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    info: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = build_suffix_array_sharded(text_dev, mesh, info=info, msd=msd)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = sharded_counts()
    check_sharded_launches(counts, n_shards, f"{name} P={n_shards}",
                           info["path"], info.get("msd_sorts", 0))
    with env(**(PLCP_ONLY if msd is False else {})):
        lcp = build_lcp_array_sharded(text_dev, sa, mesh, info=info)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    valid = is_valid_suffix_array_sharded(text_dev, sa, mesh)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    tag = f"{name} P={n_shards} msd={msd}"
    if not np.array_equal(sa.cpu().numpy(), want_sa):
        raise AssertionError(f"{tag}: SA differs from SA-IS")
    if not np.array_equal(lcp.cpu().numpy(), want_lcp):
        raise AssertionError(f"{tag}: LCP differs from Kasai")
    if not valid:
        raise AssertionError(f"{tag}: validator rejected the true SA")
    swapped, dup = sa.clone(), sa.clone()
    swapped[[10, 11]] = swapped[[11, 10]]
    dup[5] = dup[6]
    for bad, what in ((swapped, "a swapped pair"), (dup, "a duplicate")):
        if is_valid_suffix_array_sharded(text_dev, bad, mesh):
            raise AssertionError(f"{tag}: validator accepted {what}")
    want_path = ("sharded_doubling" if msd is False
                 else "sharded_msd" if name != "words" else None)
    if want_path and info["path"] != want_path:
        raise AssertionError(f"{tag}: took {info['path']}, not {want_path}")
    out = {"P": n_shards, "msd": msd, "path": info["path"],
           "msd_sorts": info.get("msd_sorts", 0),
           "chain_mode": info.get("chain_mode"),
           "n_words": info.get("n_words"), "rounds": info.get("rounds"),
           "plcp_rounds": info.get("plcp_rounds"), "sa_s": t1 - t0,
           "lcp_s": t2 - t1, "validate_s": t3 - t2,
           "peak_gib": peak / 2**30, "launches": counts}
    phase(f"[12a] {name} n=2^24 P={n_shards} "
          f"{'default route' if msd is None else 'msd=False'}: SA == "
          f"SA-IS, LCP == Kasai, validator YES/NO/NO ok; {json.dumps(out)} "
          f"({card})")
    return out


def sharded_cli(text: np.ndarray, ref: dict, card: str) -> dict:
    """[12b] cli.run with the sharded backend on SHARDED_P shards of the
    one card at 2^28, validated, on the carried-keys route (one sort, K1
    once per shard), byte for byte against the single-device run of
    phase 5; then the distributed PLCP alone on its SA (the carried-keys
    reroute held off), timed. Returns the launch counts of the CLI
    run."""
    mesh = make_mesh(SHARDED_P, devices=["cuda:0"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    arrays: dict = {}
    reset_launches()
    res = cli_run(text, "random_alnum_2^28", "cuda", validate=True,
                  dialect="both", out=buf, arrays=arrays, backend="sharded",
                  mesh=mesh)
    counts = sharded_counts()
    peak = torch.cuda.max_memory_allocated()
    report = buf.getvalue()
    for needle in ("Valid suffix array: YES", "PATH:sharded_msd\n",
                   f"mesh: {SHARDED_P} shards on 1 card(s)",
                   f"PROCESSES:{SHARDED_P}\n", f"MPI_PROCESSES:{SHARDED_P}\n",
                   "IMPLEMENTATION:cuda_sharded\n"):
        if needle not in report:
            raise AssertionError(f"sharded cli.run lacks {needle!r}:\n"
                                 + report)
    check_sharded_launches(counts, SHARDED_P, "sharded cli.run 2^28",
                           res["path"], 1)
    if not (torch.equal(arrays["sa"].cpu(), ref["sa"])
            and torch.equal(arrays["lcp"].cpu(), ref["lcp"])):
        raise AssertionError("sharded cli.run 2^28: SA or LCP differs from "
                             "the single-device run")
    text_dev = as_byte_tensor(text, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with env(**PLCP_ONLY):
        build_lcp_array_sharded(text_dev, arrays["sa"], mesh)
    torch.cuda.synchronize()
    plcp_s = time.perf_counter() - t0
    phase(f"[12b] cli.run n=2^28 random alnum, --backend sharded, "
          f"{SHARDED_P} shards on one card: Valid suffix array: YES; "
          f"PATH:{res['path']} chain_mode={res.get('chain_mode')} "
          f"n_words={res.get('n_words')}; SA and LCP == the single-device "
          f"run's, byte for byte; SA_TIME {res['sa_time']:.3f} s (one "
          f"carried-keys sort, SA and LCP), LCP_TIME {res['lcp_time']:.3f} "
          f"s (LRS), TOTAL_TIME {res['total_time']:.3f} s; distributed PLCP "
          f"alone {plcp_s:.3f} s; peak {peak / 2**30:.2f} GiB; launches "
          f"{json.dumps(counts)} ({card})")
    return counts


def sharded_chain(text: np.ndarray, ref: dict, card: str) -> None:
    """[12d] build_sa_lcp_sharded on SHARDED_P shards at 2^28 p1000:
    chain mode, byte for byte against phase 6's single-device arrays."""
    mesh = make_mesh(SHARDED_P, devices=["cuda:0"])
    text_dev = as_byte_tensor(text, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    info: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa, lcp = build_sa_lcp_sharded(text_dev, mesh, info=info)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = sharded_counts()
    check_sharded_launches(counts, SHARDED_P, "sharded p1000 2^28",
                           info["path"], info.get("msd_sorts", 0))
    if info["path"] != "sharded_msd" or not info.get("chain_mode"):
        raise AssertionError(f"sharded p1000 2^28 did not take chain mode: "
                             f"{info}")
    if not (torch.equal(sa.cpu(), ref["sa"])
            and torch.equal(lcp.cpu(), ref["lcp"])):
        raise AssertionError("sharded p1000 2^28: SA or LCP differs from "
                             "the single-device run")
    phase(f"[12d] build_sa_lcp_sharded n=2^28 p1000, {SHARDED_P} shards on "
          f"one card: SA and LCP == the single-device run's, byte for "
          f"byte; path {info['path']} chain_mode {info['chain_mode']} "
          f"n_words {info['n_words']} msd_sorts {info['msd_sorts']}; "
          f"{dt:.3f} s; peak {peak / 2**30:.2f} GiB; launches "
          f"{json.dumps(counts)} ({card})")


def sharded_sweep(card: str) -> None:
    """[12c] bench/mesh_sweep at SWEEP_MB MB random on one card and on 2,
    4 and 8 shards of it: every row a success on platform cuda, and
    parallel_results.csv with the harness's columns."""
    rows = mesh_sweep.main(
        sizes_mb=(SWEEP_MB,), out_dir=OUT_DIR / "mesh",
        data_dir=OUT_DIR / "data", device="cuda", families=("random",),
        charts=False, verbose=False)
    backends = [r["backend"] for r in rows]
    want = ["cuda"] + [f"cuda_sharded_{p}" for p in (2, 4, 8)]
    if backends != want or any(not r["success"] or r["platform"] != "cuda"
                               for r in rows):
        raise AssertionError(f"mesh sweep rows: {rows}")
    with open(OUT_DIR / "mesh" / "parallel_results.csv", newline="") as f:
        reader = csv.DictReader(f)
        par = list(reader)
    extra = ["speedup", "efficiency", "baseline_builder", "builder_mismatch"]
    if reader.fieldnames != HARNESS_COLUMNS + extra or len(par) != 3:
        raise AssertionError(f"parallel_results.csv: {reader.fieldnames}, "
                             f"{len(par)} rows")
    for row in rows:
        phase(f"[12c] mesh sweep random_{SWEEP_MB}MB {row['backend']}: "
              f"builder {row['builder']}, {row_times(row)} ({card})")
    phase(f"[12c] parallel_results.csv: speedup "
          f"{[round(float(r['speedup']), 4) for r in par]}, efficiency "
          f"{[round(float(r['efficiency']), 4) for r in par]}, "
          f"builder_mismatch {[r['builder_mismatch'] for r in par]}")


def mp_worker(argv: list[str]) -> int:
    """``chip_smoke.py --mp-worker OUT ARGS...``: one worker of the
    multi-process CLI (``cli_distributed.run_distributed`` on the CLI's
    ARGS), with its launch counts set to 0 just before and read just
    after. Writes ``OUT/rank<r>.json`` (the results, its launches and
    peak) and its local shards of the padded SA and LCP as
    ``OUT/sa.<shard>.npy`` and ``OUT/lcp.<shard>.npy``."""
    out = pathlib.Path(argv[0])
    args = cli_parse_args(argv[1:])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    arrays: dict = {}
    rc = run_distributed(args, arrays)
    counts = sharded_counts()
    for me, (sa, lcp) in enumerate(zip(arrays["sa"], arrays["lcp"])):
        if sa is not None:
            np.save(out / f"sa.{me}.npy", sa.cpu().numpy())
            np.save(out / f"lcp.{me}.npy", lcp.cpu().numpy())
    (out / f"rank{args.process_id}.json").write_text(json.dumps({
        "results": arrays["results"], "launches": counts,
        "peak_bytes": torch.cuda.max_memory_allocated()}))
    return rc


def fresh_dir(path: pathlib.Path) -> pathlib.Path:
    if path.exists():
        for f in path.iterdir():
            f.unlink()
    path.mkdir(parents=True, exist_ok=True)
    return path


def joined(out: pathlib.Path, col: str, n_shards: int) -> np.ndarray:
    return np.concatenate([np.load(out / f"{col}.{i}.npy")
                           for i in range(n_shards)])


def summed(ranks: list[dict]) -> dict:
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


def mp_cli(tag: str, path: pathlib.Path, n_proc: int, dpp: int,
           gloo: bool) -> dict:
    """The launcher ``--spawn n_proc --devices-per-process dpp`` on
    ``path``, each worker this script's ``--mp-worker``; fails if the
    launch fails. Returns process 0's report and parsed MPI block, the
    ranks' reports, the joined padded SA and LCP and the summed
    launches."""
    out = fresh_dir(OUT_DIR / "mp" / tag)
    args = cli_parse_args([str(path), "--spawn", str(n_proc),
                           "--devices-per-process", str(dpp)])
    worker = [sys.executable, str(pathlib.Path(__file__).resolve()),
              "--mp-worker", str(out)]
    log = out / "stdout.txt"
    with env(**({"SA_PG_BACKEND": "gloo"} if gloo else {})), \
            open(log, "w") as f:
        rc = spawn(args, worker=worker, stdout=f)
    report = log.read_text()
    if rc:
        raise AssertionError(f"[13] {tag}: the launch exited {rc}:\n"
                             + report[-3000:])
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(n_proc)]
    n_shards = n_proc * dpp
    return {"report": report, "mpi": parse_structured_results(report),
            "ranks": ranks, "sa": joined(out, "sa", n_shards),
            "lcp": joined(out, "lcp", n_shards), "launches": summed(ranks),
            "peak_gib": max(r["peak_bytes"] for r in ranks) / 2**30}


def check_mp_arrays(tag: str, got: dict, n: int, want_sa: np.ndarray,
                    want_lcp: np.ndarray) -> None:
    """Rows [0, n) of the joined padded arrays equal the reference, pad
    rows hold n (SA) and 0 (LCP)."""
    sa, lcp = got["sa"], got["lcp"]
    if not (np.array_equal(sa[:n], want_sa)
            and np.array_equal(lcp[:n], want_lcp)):
        raise AssertionError(f"[13] {tag}: SA or LCP differs from the "
                             "reference")
    if not ((sa[n:] == n).all() and (lcp[n:] == 0).all()):
        raise AssertionError(f"[13] {tag}: pad rows are not n / 0")


def check_mp_report(tag: str, got: dict, path: str, n_proc: int) -> None:
    report, mpi = got["report"], got["mpi"]
    if ("Valid suffix array: YES" not in report
            or mpi.get("path") != path
            or mpi.get("mpi_processes") != n_proc
            or report.count("--- STRUCTURED_RESULTS ---") != 1):
        raise AssertionError(f"[13] {tag}: expected valid YES, PATH:{path}"
                             f", MPI_PROCESSES:{n_proc}:\n{report[-3000:]}")


def mp_nccl(text: np.ndarray, ref: dict, want_counts: dict,
            card: str) -> dict:
    """[13a] the launcher, 1 process x MP_DPP shards on NCCL, on a file
    holding ``text`` (phase 5's); [13a'] the library entry in the same
    geometry. Returns [13a]'s summed launches."""
    n = len(text)
    path = OUT_DIR / "data" / "alnum_2^28.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    text.tofile(path)
    want_sa, want_lcp = ref["sa"].numpy(), ref["lcp"].numpy()
    lrs = find_longest_repeated_substring(
        text, ref["sa"].cuda(), ref["lcp"].cuda(), device="cuda")
    torch.cuda.empty_cache()
    got = mp_cli("13a", path, 1, MP_DPP, gloo=False)
    check_mp_report("13a", got, "sharded_msd_mp", 1)
    line = (f"Longest repeated substring: '{lrs.decode()}' (length: "
            f"{len(lrs)})")
    if line not in got["report"]:
        raise AssertionError(f"[13a] the LRS is not phase 5's {line!r}")
    if "process group: backend nccl" not in got["report"]:
        raise AssertionError("[13a] did not run on NCCL")
    check_mp_arrays("13a", got, n, want_sa, want_lcp)
    check_mp_launches("13a", got["launches"], want_counts)
    cli_counts = got["launches"]
    phase(f"[13a] --spawn 1 --devices-per-process {MP_DPP} (NCCL) n=2^28 "
          f"random alnum file: Valid suffix array: YES; "
          f"PATH:{got['mpi']['path']}; LRS == phase 5's; SA and LCP == "
          f"phase 5's, byte for byte; SA_TIME {got['mpi']['sa_time']:.3f} "
          f"s, LCP_TIME {got['mpi']['lcp_time']:.3f} s, TOTAL_TIME "
          f"{got['mpi']['total_time']:.3f} s; peak {got['peak_gib']:.2f} "
          f"GiB; launches {json.dumps(got['launches'])} ({card})")
    del got
    # [13a'] the library entry, 1 process x MP_DPP shards, NCCL.
    out = fresh_dir(OUT_DIR / "mp" / "13a_lib")
    worker = pathlib.Path(weak_scaling.__file__).with_name(
        "weak_scaling_worker.py")
    store = out.resolve() / "pg_store"
    log = out / "stdout.txt"
    with open(log, "w") as f:
        rc = run_workers([[sys.executable, str(worker), "0", "1",
                           f"file://{store}", str(n // MP_DPP), str(MP_DPP),
                           "--device", "cuda", "--corpus", "random",
                           "--seed", str(SEED), "--lcp", "--out", str(out)]],
                         stdout=f, timeout=600)
    if rc:
        raise AssertionError(f"[13a'] the worker exited {rc}:\n"
                             + log.read_text()[-3000:])
    ranks = [json.loads((out / "rank0.json").read_text())]
    lib = {"sa": joined(out, "sa", MP_DPP), "lcp": joined(out, "lcp",
                                                         MP_DPP)}
    check_mp_arrays("13a'", lib, n, want_sa, want_lcp)
    counts = summed(ranks)
    check_mp_launches("13a'", counts, want_counts)
    phase(f"[13a'] build_suffix_array_sharded_big_mp, 1 process x {MP_DPP} "
          f"shards (NCCL), n=2^28 random alnum: SA and LCP == phase 5's, "
          f"byte for byte; SA_TIME (SA+LCP, warm) {ranks[0]['sa_time']:.3f} "
          f"s; peak {ranks[0]['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{json.dumps(counts)} ({card})")
    return cli_counts


def check_mp_launches(tag: str, counts: dict, want: dict) -> None:
    """The kernels' launches equal the single-process run's ([12b])."""
    keys = ("pack_words", "pack_ranks", "digit_histograms", "onesweep_pass",
            "block_digit_sort", "place_runs")
    if any(counts[k] != want[k] for k in keys):
        raise AssertionError(f"[13] {tag}: launches {counts}, not [12b]'s "
                             f"{ {k: want[k] for k in keys} }")


def mp_gloo(card: str) -> None:
    """[13b] 2 processes x 2 shards sharing the card on gloo."""
    mesh = make_mesh(4, devices=["cuda:0"])
    for name, gen in (("random alnum", generate_random_text),
                      ("repetitive p1000", generate_repetitive_text)):
        text = gen(MP_N, SEED)
        info: dict = {}
        sa, lcp = build_sa_lcp_sharded(as_byte_tensor(text, "cuda"), mesh,
                                       info=info)
        want = (sa.cpu().numpy(), lcp.cpu().numpy())
        del sa, lcp
        torch.cuda.empty_cache()
        path = OUT_DIR / "data" / f"mp_{name.split()[0]}_2^26.txt"
        text.tofile(path)
        got = mp_cli(f"13b_{name.split()[0]}", path, 2, 2, gloo=True)
        check_mp_report(f"13b {name}", got, "sharded_msd_mp", 2)
        check_mp_arrays(f"13b {name}", got, MP_N, *want)
        phase(f"[13b] --spawn 2 --devices-per-process 2 (gloo, one card) "
              f"n=2^26 {name}: Valid suffix array: YES; "
              f"PATH:{got['mpi']['path']}; SA and LCP == the single-process "
              f"sharded build's ({info['path']}, chain_mode "
              f"{info.get('chain_mode')}), byte for byte; SA_TIME "
              f"{got['mpi']['sa_time']:.3f} s, TOTAL_TIME "
              f"{got['mpi']['total_time']:.3f} s; peak {got['peak_gib']:.2f} "
              f"GiB (per process, max); launches "
              f"{json.dumps(got['launches'])} ({card})")
    text = generate_words_text(MP_WORDS_N, SEED)
    want_sa = native.sa_build(text)
    want_lcp = native.lcp_kasai(text, want_sa)
    path = OUT_DIR / "data" / "mp_words_2^22.txt"
    text.tofile(path)
    got = mp_cli("13b_words", path, 2, 2, gloo=True)
    check_mp_report("13b words", got, "sharded_doubling", 2)
    check_mp_arrays("13b words", got, MP_WORDS_N, want_sa, want_lcp)
    phase(f"[13b] --spawn 2 --devices-per-process 2 (gloo, one card) "
          f"n=2^22 words: refused by the carried keys, Valid suffix array: "
          f"YES; PATH:{got['mpi']['path']}; SA == SA-IS, LCP == Kasai; "
          f"SA_TIME {got['mpi']['sa_time']:.3f} s, TOTAL_TIME "
          f"{got['mpi']['total_time']:.3f} s; peak {got['peak_gib']:.2f} "
          f"GiB; launches {json.dumps(got['launches'])} ({card})")


def mp_weak(card: str) -> None:
    """[13c] the weak-scaling runner at WEAK_BYTES per shard on the card;
    its CSV read back."""
    out = OUT_DIR / "weak"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rows = weak_scaling.main(WEAK_BYTES, out_dir=out, device="cuda",
                             charts=False, verbose=False)
    dt = time.perf_counter() - t0
    counts = sharded_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(out / "weak_scaling.csv", newline="") as f:
        back = list(csv.DictReader(f))
    per = {b: [r for r in back if r["builder"] == b] for b in WEAK_BUILDERS}
    if (len(back) != len(rows)
            or any(len(per[b]) != k for b, k in WEAK_BUILDERS.items())
            or any(r["success"] != "True" for r in back)):
        raise AssertionError(f"[13c] weak_scaling.csv: {back}")
    for b, rs in per.items():
        phase(f"[13c] weak scaling {b}, {WEAK_BYTES >> 20} MiB per shard, "
              f"P {[int(r['processes']) for r in rs]} "
              f"({rs[0]['scaling_mode']}): sa_time s "
              f"{[float(r['sa_time']) for r in rs]}, P*t1/tP "
              f"{[round(float(r['weak_efficiency_normalized']), 4) for r in rs]}"
              + (f", peak GiB {[int(r['peak_bytes']) / 2**30 for r in rs]}, "
                 f"launches {[r['launches'] for r in rs]}"
                 if b == "msd_2proc" else "") + f" ({card})")
    phase(f"[13c] the runner, {dt:.1f} s: in this process (the one-process "
          f"builders, each P a warm-up and a timed run) peak "
          f"{peak / 2**30:.2f} GiB, launches {json.dumps(counts)}; the "
          f"msd_2proc workers' own are in their rows ({card})")


def lcp_corpora() -> dict:
    """The four corpora of [14a] at LCP_N bytes, made on the card (words
    on the host: it has no card generator)."""
    return {
        "random alnum": device_random_text(LCP_N, SEED, "cuda"),
        "DNA": device_dna_text(LCP_N, SEED, "cuda"),
        "repetitive p1000": device_repetitive_text(LCP_N, SEED, "cuda"),
        "words": torch.from_numpy(generate_words_text_batched(LCP_N, SEED)),
    }


def sorted_k1_launches(text: np.ndarray) -> int:
    """K1 launches of one sorted-fetch LCP: one per three key words."""
    remap, bits, _ = alphabet_remap(text)
    wn = _pick_wn(len(text), int(remap.max()), 30 // bits)
    return -(-wn // 3)


def lcp_cli(name: str, text: np.ndarray, card: str) -> np.ndarray:
    """[14a] cli.run at LCP_N on ``text``: the SA on the direct route, the
    LCP on LCP_ROUTES[name], both equal to SA-IS and Kasai; then
    build_lcp_array on the same SA under SA_LCP_FETCH=sorted and =window,
    each with its own launch counts. Returns the SA."""
    want_sa = native.sa_build(text)
    want_lcp = native.lcp_kasai(text, want_sa)
    arrays: dict = {}
    buf = io.StringIO()
    reset_launches()
    res = cli_run(text, f"{name}_6MiB", "cuda", validate=True,
                  dialect="sequential", out=buf, arrays=arrays)
    counts = launches()
    if "Valid suffix array: YES" not in buf.getvalue():
        raise AssertionError(f"[14a] {name} not validated")
    if res["path"] != "direct":
        raise AssertionError(f"[14a] {name}: SA route {res['path']}")
    if not (np.array_equal(arrays["sa"].cpu().numpy(), want_sa)
            and np.array_equal(arrays["lcp"].cpu().numpy(), want_lcp)):
        raise AssertionError(f"[14a] {name}: SA or LCP differs from "
                             "SA-IS/Kasai")
    lcp_path, finish = LCP_ROUTES[name]
    if ((res.get("lcp_path"), res.get("lcp_finish")) != (lcp_path, finish)
            or bool(res.get("lcp_declined")) != (lcp_path == "plcp")):
        raise AssertionError(f"[14a] {name}: LCP route {res}")
    check_launches(counts, f"[14a] {name}")
    route = {k: res.get(k) for k in ("path", "lcp_path", "lcp_misses",
                                     "lcp_finish", "lcp_declined",
                                     "plcp_rounds")}
    phase(f"[14a] cli.run n=6 MiB {name}: Valid suffix array: YES; SA == "
          f"SA-IS, LCP == Kasai; {json.dumps(route)}; SA "
          f"{res['sa_time']:.4f} s, LCP+LRS {res['lcp_time']:.4f} s; "
          f"launches {json.dumps(counts)} ({card})")
    t = as_byte_tensor(text, "cuda")
    k1 = sorted_k1_launches(text)
    for fetch in ("sorted", "window"):
        info: dict = {}
        with env(SA_LCP_FETCH=fetch):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            lcp = build_lcp_array(text, arrays["sa"], device="cuda",
                                  info=info, text_dev=t)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launches()
        if not np.array_equal(lcp.cpu().numpy(), want_lcp):
            raise AssertionError(f"[14a] {name} {fetch}: LCP != Kasai")
        want_path = fetch if lcp_path != "plcp" else "plcp"
        want_k1 = k1 if fetch == "sorted" else 0
        if info["lcp_path"] != want_path or counts["pack_words"] != want_k1:
            raise AssertionError(f"[14a] {name} {fetch}: {info}, K1 "
                                 f"{counts['pack_words']} != {want_k1}")
        phase(f"[14a] build_lcp_array n=6 MiB {name}, SA_LCP_FETCH={fetch}:"
              f" LCP == Kasai; lcp_path {info['lcp_path']}, misses "
              f"{info.get('lcp_misses')}, finish {info.get('lcp_finish')}, "
              f"refusal {info.get('lcp_declined')!r}; {dt * 1e3:.2f} ms; K1 "
              f"launches {counts['pack_words']} ({card})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plcp, rounds = plcp_kernel(t, arrays["sa"])
    lcp = lcp_from_plcp(plcp, arrays["sa"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not np.array_equal(lcp.cpu().numpy(), want_lcp):
        raise AssertionError(f"[14a] {name}: PLCP != Kasai")
    phase(f"[14a] PLCP n=6 MiB {name} on the same SA: LCP == Kasai; "
          f"{dt * 1e3:.2f} ms ({rounds} rounds) ({card})")
    return want_sa


def warm_times(fn, reps: int = 3) -> list[float]:
    """Host-clock seconds of ``reps`` calls of ``fn`` after a warm-up
    call, each fenced by a device synchronise."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def lcp_full(text: np.ndarray, ref: dict, card: str) -> dict:
    """[14b] 2^28 random alnum (phase 5's text): the sorted-fetch and
    window routes against phase 5's LCP, byte for byte, warm, with the
    peak above the inputs and K1's launches; PLCP on the same SA; then
    K1 alone at the route's shape (contiguous words and the row-major
    table) and the gather into SA order, each beside its bound."""
    n = len(text)
    torch.cuda.empty_cache()
    t = as_byte_tensor(text, "cuda")
    sa = ref["sa"].to("cuda")
    want = ref["lcp"].to("cuda")
    out = {}
    for route, prepare, build in (
            ("sorted", lambda: prepare_lcp_sorted(text, t, device="cuda"),
             build_lcp_array_sorted),
            ("window", lambda: prepare_lcp(text, device="cuda", text_dev=t),
             build_lcp_array_window)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = prepare()
        got = build(text, sa, state)
        counts = launches()
        if not torch.equal(got, want):
            raise AssertionError(f"[14b] {route}: LCP differs from phase "
                                 "5's")
        del got
        peak = torch.cuda.max_memory_allocated() - base
        times = warm_times(lambda: build(text, sa, state))
        out[route] = {"s": statistics.median(times), "times": times,
                      "peak": peak, "k1": counts["pack_words"],
                      "state": state}
        phase(f"[14b] {route} route n=2^28 random alnum: LCP == phase 5's, "
              f"byte for byte; warm median of 3 {out[route]['s']:.4f} s "
              f"({', '.join(f'{x:.4f}' for x in times)}); peak "
              f"{peak / 2**30:.2f} GiB above the text and SA "
              f"({peak / n:.1f} B a row); K1 launches "
              f"{counts['pack_words']} ({card})")
    sorted_state = out["sorted"]["state"]
    if out["sorted"]["k1"] != sorted_k1_launches(text):
        raise AssertionError(f"[14b] sorted: K1 {out['sorted']['k1']}")
    del out["window"]["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plcp, rounds = plcp_kernel(t, sa)
    lcp = lcp_from_plcp(plcp, sa)
    torch.cuda.synchronize()
    plcp_s = time.perf_counter() - t0
    if not torch.equal(lcp, want):
        raise AssertionError("[14b] PLCP differs from phase 5's")
    del plcp, lcp
    phase(f"[14b] PLCP on the same SA: {plcp_s:.4f} s ({rounds} rounds); "
          f"sorted / PLCP {out['sorted']['s'] / plcp_s:.3f} ({card})")
    # K1 alone at the route's shape.
    st = sorted_state
    nw, spw, bits, table = st["wn"], st["spw"], st["bits"], st["table"]
    if nw > 3:
        raise AssertionError(f"[14b] wn {nw}: one K1 launch expected")
    plain = pack_words_reference(t, table, bits, spw, n, nw)
    err = exact(pack_words(t, table, bits, spw, n, nw), plain,
                "[14b] K1 words")
    tab = torch.empty((n, nw), dtype=torch.int32, device="cuda")
    cols = [tab[:, w] for w in range(nw)]
    err = max(err, exact(pack_words(t, table, bits, spw, n, nw, out=cols),
                         plain, "[14b] K1 table"))
    del plain
    k1 = {"rows": n, "n_words": nw, "max_abs_err": err,
          "ms": median_ms(lambda _: pack_words(t, table, bits, spw, n, nw)),
          "table_ms": median_ms(lambda _: pack_words(
              t, table, bits, spw, n, nw, out=cols)),
          "plain_ms": median_ms(lambda _: pack_words_reference(
              t, table, bits, spw, n, nw))}
    k1.update(k1_bound(k1))
    del tab, cols
    word = sorted_words(st)[0]
    gather_ms = median_ms(lambda _: torch.index_select(word, 0, sa))
    gather_bound = bound(3 * 4 * n, 0)["bound_ms"]
    phase(f"[14b] K1 n=2^28 random alnum, the route's shape ({nw} words, "
          f"spw {spw}): exact; contiguous words {k1['ms']:.3f} ms, into a "
          f"row-major ({nw}) table {k1['table_ms']:.3f} ms, plain "
          f"{k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.3f} ms; the "
          f"gather of one word into SA order {gather_ms:.3f} ms, bound "
          f"{gather_bound:.3f} ms ({card})")
    k1.update(launches=out["sorted"]["k1"], gather_ms=gather_ms,
              gather_bound_ms=gather_bound)
    return k1


def lcp_routes(sharded_ref: tuple, card: str) -> dict:
    """Phase 14: the window and sorted-fetch LCP routes and the
    SA_CHAIN_MIN branch. Returns K1's numbers at [14b]'s shape."""
    t14 = time.perf_counter()
    texts = {k: v.cpu().numpy() for k, v in lcp_corpora().items()}
    sas = {name: lcp_cli(name, text, card) for name, text in texts.items()}
    torch.cuda.empty_cache()
    k1 = lcp_full(*sharded_ref, card)
    torch.cuda.empty_cache()
    # [14c] the SA_CHAIN_MIN branch, alive once SA_BIG_THRESHOLD is above
    # the text: deep repeats take the carried keys, the rest doubling.
    with env(SA_BIG_THRESHOLD=CHAIN_BIG):
        for name, path in (("repetitive p1000", "direct"),
                           ("random alnum", "doubling")):
            arrays: dict = {}
            buf = io.StringIO()
            res = cli_run(texts[name], f"{name}_6MiB", "cuda", validate=True,
                          dialect="sequential", out=buf, arrays=arrays)
            report = buf.getvalue()
            if (f"PATH:{path}\n" not in report
                    or "Valid suffix array: YES" not in report
                    or not np.array_equal(arrays["sa"].cpu().numpy(),
                                          sas[name])):
                raise AssertionError(f"[14c] {name}: not PATH:{path} with "
                                     f"[14a]'s SA:\n{report}")
            phase(f"[14c] SA_BIG_THRESHOLD={CHAIN_BIG} cli.run n=6 MiB "
                  f"{name}: PATH:{res['path']} chain_mode="
                  f"{res.get('chain_mode')}; SA == [14a]'s; SA "
                  f"{res['sa_time']:.4f} s ({card})")
    # [14d] python -m runs the CLI, on the card by default.
    proc = subprocess.run([sys.executable, "-m", "hpc_suffix_array_tpu_torch",
                           "banana"], capture_output=True, text=True,
                          timeout=300)
    if (proc.returncode != 0
            or "Longest repeated substring: 'ana' (length: 3)"
            not in proc.stdout or "IMPLEMENTATION:cuda\n" not in proc.stdout):
        raise AssertionError(f"[14d] python -m: {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
    phase(f"[14d] python -m hpc_suffix_array_tpu_torch banana: Longest "
          f"repeated substring: 'ana' (length: 3), IMPLEMENTATION:cuda "
          f"({card})")
    phase(f"[14] LCP routes: {time.perf_counter() - t14:.1f} s")
    return k1


def headline_bench(cli_sa_time: float, card: str) -> dict:
    """Phase 15: ``python3 bench_cuda.py`` at its defaults in a process
    of its own. Checks its one stdout line (2^30, the MSD route, no OOM
    fallback, the host SA-IS baseline), the six secondary metrics on
    their routes and its kernels' launch counts (the bench prints them);
    prints every metric line. Returns the launch counts."""
    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve().parent
                             / "bench_cuda.py")],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("SA_")})
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "headline.err").write_text(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"[15] bench_cuda.py exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        raise AssertionError(f"[15] bench_cuda.py stdout:\n{proc.stdout}")
    line = json.loads(lines[0])
    if (line.get("metric") != "suffix_array_build_throughput"
            or line.get("n") != MSD_N or line.get("path") != "msd_bigsort"
            or "oom_fallback" in line or not line.get("value", 0) > 0
            or line.get("baseline") != "host_sais"
            or not line.get("vs_baseline", 0) > 0):
        raise AssertionError(f"[15] headline line: {line}")
    recs, launches = {}, None
    for ln in proc.stderr.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            recs[rec["metric"]] = rec
            phase(f"[15] {ln}")
        elif ln.startswith("# launches: "):
            launches = json.loads(ln[len("# launches: "):])
        elif ln.startswith("#"):
            phase(f"[15] {ln}")
    for metric, (key, want) in HEADLINE_ROUTES.items():
        rec = recs.get(metric)
        if not rec or not rec["value"] > 0 or rec.get(key) != want:
            raise AssertionError(f"[15] {metric}: {rec}, want {key} {want}")
    if not recs["sa_build_words"].get("refine_members"):
        raise AssertionError(f"[15] words did not refine: "
                             f"{recs['sa_build_words']}")
    if (launches is None
            or any(launches[k] == 0 for k in (
                "pack_ranks", "pack_words", "digit_histograms",
                "onesweep_pass"))
            or launches["block_digit_sort"] or launches["place_runs"]):
        raise AssertionError(f"[15] launches {launches}")
    secs = line["n"] / (line["value"] * 1e6)
    phase(f"[15] {lines[0]}")
    phase(f"[15] headline: build {secs:.3f} s at 2^30 random alnum "
          f"(best of 3, timed replan + execute_big) beside [8c]'s CLI "
          f"SA_TIME {cli_sa_time:.3f} s (staging and alphabet included); "
          f"launches {json.dumps(launches)} ({card})")
    phase(f"[15] headline benchmark: {time.perf_counter() - t15:.1f} s")
    return launches


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

    # 3) kernels vs plain
    rng = np.random.default_rng(SEED)
    for n, bits, h0 in SMALL_CASES:
        text = rng.integers(0, 256, n).astype(np.uint8)
        remap = rng.integers(0, min(1 << bits, 257), 256).astype(np.int32)
        compare_pack(text, remap, bits, h0, n)
        compare_pack(text, remap, bits, h0, n // 3)       # masked tail
    zero_tail = np.zeros(1024, np.uint8)
    zero_tail[:100] = rng.integers(1, 4, 100)
    compare_pack(zero_tail, np.arange(256, dtype=np.int32) % 4, 2, 15, 1024)
    n_word = 0
    for bits, spw in WORD_CASES:
        for n in WORD_SIZES:
            text = rng.integers(0, 256, n).astype(np.uint8)
            remap = rng.integers(1, 1 << bits, 256).astype(np.int32)
            for table in (remap, np.maximum(remap - 1, 0)):   # minpad
                for word in range(3):
                    compare_pack(text, table, bits, spw, n, word * spw)
                    n_word += 1
                for offset in (0, 1, 7):
                    compare_words(text, table, bits, spw, 3, offset)
                    n_word += 1
    phase(f"[3] pack word mode: {n_word} cases exact (words 0-2 one at a "
          f"time, and three words in one launch at offsets 0, 1, 7; (bits, "
          f"spw) {WORD_CASES}, n {WORD_SIZES}, with and without minpad)")
    alnum = generate_random_text(FULL_N, SEED)
    for name, text in (("random alnum", alnum),
                       ("DNA", generate_dna_text(FULL_N, SEED))):
        remap, bits, h0 = alphabet_remap(text)
        r = compare_pack(text, remap, bits, h0, FULL_N, timed=True)
        phase(f"[3] pack {name} n=2^28 bits={bits} h0={h0}: exact; kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms ({card})")
    words = generate_words_text(FULL_N, SEED)
    k1 = k1_modes(alnum, words)
    for name, r in k1.items():
        r.update(k1_bound(r))
        phase(f"[3] K1 n=2^28 {name} ({r['n_words']} word(s)): exact; "
              f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms ({card})")
    torch.cuda.empty_cache()
    radix_err = {"k2": 0, "k3": 0}
    k23 = None
    for n in (1 << 16, FULL_N):
        for rbits in (4, 8):
            for kind_ in ("uniform", "skewed"):
                timed = n == FULL_N and rbits == 8 and kind_ == "uniform"
                r = compare_radix_pass(n, rbits, kind_, timed)
                radix_err["k2"] = max(radix_err["k2"], r["k2_err"])
                radix_err["k3"] = max(radix_err["k3"], r["k3_err"])
                if timed:
                    k23 = r
                torch.cuda.empty_cache()
    phase("[3] K2 block_digit_sort + K3 place_runs: exact at rbits 4 and "
          "8, n 2^16 and 2^28, uniform and skewed keys")
    phase(f"[3] K2 n=2^28 rbits=8, 3 int32 columns: kernel "
          f"{k23['k2_ms']:.3f} ms, plain {k23['k2_plain_ms']:.3f} ms; K3: "
          f"kernel {k23['k3_ms']:.3f} ms, plain {k23['k3_plain_ms']:.3f} "
          f"ms ({card})")
    os_err = {"hist": 0, "pass": 0}
    for n in (1 << 16, FULL_N):
        for rbits in (4, 8):
            for kind_ in ("uniform", "skewed", "constant"):
                r = compare_onesweep(n, rbits, kind_)
                os_err["hist"] = max(os_err["hist"], r["hist_err"])
                os_err["pass"] = max(os_err["pass"], r["pass_err"])
                torch.cuda.empty_cache()
    phase("[3] digit_histograms + onesweep_pass: exact at rbits 4 and 8, "
          "n 2^16 and 2^28, uniform, skewed and constant keys")
    one = {}
    for n_cols in (3, 4):
        one[n_cols] = time_passes(n_cols)
        torch.cuda.empty_cache()
        phase(f"[3] one pass n=2^28 rbits=8, {n_cols} int32 columns: "
              f"onesweep {one[n_cols]['ms']:.3f} ms, K2 + glue + K3 "
              f"{one[n_cols]['k23_ms']:.3f} ms, plain "
              f"{one[n_cols]['plain_ms']:.3f} ms; the K2 + glue + K3 pass "
              f"== the onesweep pass, launches "
              f"{json.dumps(one[n_cols]['k23_launches'])} ({card})")
    srt = compare_sort(alnum)
    phase(f"[3] digit_histograms n=2^28 alnum (k0, k1): exact; kernel "
          f"{srt['hist_ms']:.3f} ms, plain {srt['hist_plain_ms']:.3f} ms "
          f"({card})")
    phase(f"[3] radix_sort_words n=2^28 alnum (k0, k1, idx): exact; passes "
          f"run/skipped {srt['passes'][0]}/{srt['passes'][1]}; kernel "
          f"{srt['ms']:.3f} ms, plain (stable torch.sort per word) "
          f"{srt['plain_ms']:.3f} ms, torch.sort of the 60-bit key "
          f"{srt['torch_sort_ms']:.3f} ms ({card})")
    rsrt = {}
    for n, tag in ((FULL_N, "2^28"), (1 << 22, "2^22")):
        rsrt[n] = compare_refine_sort(n)
        phase(f"[3] radix_sort_words refinement shape n={tag} (seg 28 bits,"
              f" w0, w1 30 bits; idx), 12 passes: exact; run/skipped "
              f"{rsrt[n]['passes'][0]}/{rsrt[n]['passes'][1]}; kernel "
              f"{rsrt[n]['ms']:.3f} ms, plain {rsrt[n]['plain_ms']:.3f} ms "
              f"({card})")
        torch.cuda.empty_cache()
    ksrt = {}
    for nw in (2, 3):
        ksrt[nw] = r = compare_keys_only_sort(alnum, 1 << 27, nw)
        phase(f"[3] radix_sort_words keys-only n=2^27 ({nw} alnum words, "
              f"tiebreak; {nw + 1} columns): exact; run/skipped "
              f"{r['passes'][0]}/{r['passes'][1]}, digit_histograms "
              f"launches {r['hist_launches']}; kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms ({card})")
        torch.cuda.empty_cache()
    sort_err = max([srt["max_abs_err"]]
                   + [r["max_abs_err"] for r in rsrt.values()]
                   + [r["max_abs_err"] for r in ksrt.values()])

    # 4) correctness through the routers
    oracles = {}
    for n in CHECK_SIZES:
        for name, gen in CORPORA:
            route, want_sa, want_lcp = check_corpus(name, gen(n, SEED))
            if n == CHECK_SIZES[-1]:
                oracles[name] = (want_sa, want_lcp)
            if name == "words" and n > (1 << 22) and (
                    route["path"] != "direct" or route["declined"]
                    or not route["refine_members"]):
                raise AssertionError(f"words n={n} did not refine on the "
                                     f"direct route: {route}")
        torch.cuda.empty_cache()

    # 5) full size, main path: the direct route through the CLI
    arrays: dict = {}
    res, counts, peak = run_cli(alnum, "random_alnum_2^28", arrays, k1=1)
    phase(f"[5] cli.run n=2^28 random alnum: Valid suffix array: YES; "
          f"PATH:{res['path']} n_words={res.get('n_words')} chain_mode="
          f"{res.get('chain_mode')} rerun={res.get('rerun')}; SA "
          f"{res['sa_time']:.3f} s, LCP+LRS {res['lcp_time']:.3f} s, "
          f"total {res['total_time']:.3f} s; peak {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(counts)} ({card})")
    against_doubling(alnum, arrays, "[5]", "random alnum", card)
    # Phase 12 holds the sharded CLI run against these arrays.
    sharded_ref = (alnum, {k: v.cpu() for k, v in arrays.items()})
    del arrays

    # 6) periodic text through the CLI: chain mode on the direct route
    p1000 = generate_repetitive_text(FULL_N, SEED)
    arrays = {}
    res, counts, peak = run_cli(p1000, "repetitive_p1000_2^28", arrays)
    # Phase 12d holds the sharded chain-mode build against these arrays.
    chain_ref = (p1000, {k: v.cpu() for k, v in arrays.items()})
    del arrays, p1000
    if not res.get("chain_mode"):
        raise AssertionError("p1000 at 2^28 did not run in chain mode")
    phase(f"[6] cli.run n=2^28 p1000: Valid suffix array: YES; "
          f"PATH:{res['path']} chain_mode={res['chain_mode']} n_words="
          f"{res.get('n_words')} rerun={res.get('rerun')}; SA "
          f"{res['sa_time']:.3f} s, LCP+LRS {res['lcp_time']:.3f} s, "
          f"total {res['total_time']:.3f} s; peak {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(counts)} ({card})")

    # 7) natural text through the CLI: the direct route with refinement
    arrays = {}
    # One K1 launch for the key words, one for the refinement's pk2.
    res, words_counts, peak = run_cli(words, "words_2^28", arrays, k1=2)
    if not res.get("refine_members") or res.get("declined"):
        raise AssertionError(f"words at 2^28 did not refine: {res}")
    phase(f"[7] cli.run n=2^28 words: Valid suffix array: YES; "
          f"PATH:{res['path']} n_words={res.get('n_words')} "
          f"{json.dumps({k: res.get(k) for k in REFINE_KEYS})}; SA "
          f"{res['sa_time']:.3f} s, LCP+LRS {res['lcp_time']:.3f} s, "
          f"total {res['total_time']:.3f} s; peak {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(words_counts)} ({card})")
    against_doubling(words, arrays, "[7]", "words", card)
    del arrays, words
    torch.cuda.empty_cache()

    # 8) the MSD bucket builder
    msd_at_2e24(oracles, card)
    msd_against_direct(alnum, card)
    del alnum
    torch.cuda.empty_cache()
    big = alnum_on_card(MSD_N, SEED)
    res, counts, peak = run_cli(big, "random_alnum_2^30", path="msd", k1=32)
    if peak >= DIRECT_PEAK_2E30:
        raise AssertionError(f"MSD 2^30 peak {peak / 2**30:.2f} GiB is not "
                             "below the direct route's 56.00 GiB")
    msd_sa_time = res["sa_time"]
    phase(f"[8c] cli.run n=2^30 random alnum: Valid suffix array: YES; "
          f"PATH:{res['path']}; SA_TIME {res['sa_time']:.3f} s, TOTAL_TIME "
          f"{res['total_time']:.3f} s; peak {peak / 2**30:.2f} GiB; "
          f"launches {json.dumps(counts)} ({card})")
    split = peak_split(big)
    del big
    phase(f"[8c] peak split n=2^30 (the CLI's phases, peak reset before "
          f"each): {json.dumps(split)} ({card})")
    torch.cuda.empty_cache()

    # 9) the largest text the package accepts, validated through the CLI
    big = alnum_on_card(MAX_N, SEED)
    res, counts, peak = run_cli(big, "random_alnum_2^31-1", path="msd")
    del big
    if peak >= CARD_BYTES:
        raise AssertionError(f"2^31 - 1 peak {peak / 2**30:.2f} GiB")
    phase(f"[9] cli.run n=2^31-1 random alnum: Valid suffix array: YES "
          f"(chunked validator); PATH:{res['path']}; SA_TIME "
          f"{res['sa_time']:.3f} s, TOTAL_TIME {res['total_time']:.3f} s; "
          f"peak {peak / 2**30:.2f} GiB; launches {json.dumps(counts)} "
          f"({card})")

    # 10) the measurement path; 11) the device trace
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    harness_counts = harness_on_card(card)
    traced_build("random_1024MB", "msd", card)
    traced_build("words_256MB", "direct", card)
    cli_trace(OUT_DIR / "data" / "random_50MB.txt")

    # 12) the sharded backend, every shard on the one card
    t12 = time.perf_counter()
    for name, gen in CORPORA:
        text = gen(SHARDED_N, SEED)
        for p in SHARDS:
            for msd in (None, False) if p in PLCP_SHARDS else (None,):
                sharded_corpus(name, text, *oracles[name], p, card, msd)
    sharded_launches = sharded_cli(*sharded_ref, card)
    torch.cuda.empty_cache()
    sharded_sweep(card)
    sharded_chain(*chain_ref, card)
    del chain_ref
    torch.cuda.empty_cache()
    phase(f"[12] sharded backend: {time.perf_counter() - t12:.1f} s")

    # 13) the multi-process path; the kernels are built, the workers load
    t13 = time.perf_counter()
    mp_launches = mp_nccl(*sharded_ref, sharded_launches, card)
    torch.cuda.empty_cache()
    mp_gloo(card)
    torch.cuda.empty_cache()
    mp_weak(card)
    phase(f"[13] multi-process path: {time.perf_counter() - t13:.1f} s")

    # 14) the window and sorted-fetch LCP routes, the SA_CHAIN_MIN branch
    torch.cuda.empty_cache()
    lcp_k1 = lcp_routes(sharded_ref, card)
    del sharded_ref

    # 15) the headline benchmark, bench_cuda.py, in a process of its own
    gc.collect()
    headline_counts = headline_bench(msd_sa_time, card)

    n = FULL_N
    tiles = n // 4096
    print(json.dumps({"kernels": [
        {"name": "pack_ranks", "route": "cuda",
         "source": "hpc_suffix_array_tpu_torch/csrc/pack.cu",
         "replaces": "hpc_suffix_array_tpu/kernels/pack.py:51",
         "launches": words_counts["pack_ranks"] + words_counts["pack_words"],
         "harness_launches": (harness_counts["pack_ranks"]
                              + harness_counts["pack_words"]),
         "sharded_launches": (sharded_launches["pack_ranks"]
                              + sharded_launches["pack_words"]),
         "mp_launches": mp_launches["pack_ranks"] + mp_launches["pack_words"],
         "headline_launches": (headline_counts["pack_ranks"]
                               + headline_counts["pack_words"]),
         "lcp_sorted_launches": lcp_k1["launches"],
         "max_abs_err": max([r["max_abs_err"] for r in k1.values()]
                            + [lcp_k1["max_abs_err"]]),
         "ms": k1["word1"]["ms"], "plain_ms": k1["word1"]["plain_ms"],
         **k1_bound(k1["word1"]),
         **{f"{mode}_{key}": k1[mode][key]
            for mode in ("word0", "view3", "two_words", "pk2")
            for key in ("ms", "plain_ms", "bound_ms")},
         **{f"lcp_sorted_{key}": lcp_k1[key]
            for key in ("ms", "table_ms", "plain_ms", "bound_ms")}},
        {"name": "digit_histograms", "route": "cuda",
         "source": "hpc_suffix_array_tpu_torch/csrc/onesweep.cu",
         "replaces": "experiments/radix_write.py:213",
         "launches": words_counts["digit_histograms"],
         "harness_launches": harness_counts["digit_histograms"],
         "sharded_launches": sharded_launches["digit_histograms"],
         "mp_launches": mp_launches["digit_histograms"],
         "headline_launches": headline_counts["digit_histograms"],
         "max_abs_err": max(os_err["hist"], srt["hist_err"]),
         "ms": srt["hist_ms"], "plain_ms": srt["hist_plain_ms"],
         **bound(2 * 4 * n + 8 * 256 * 4, 4 * 8 * n)},
        {"name": "onesweep_pass", "route": "cuda",
         "source": "hpc_suffix_array_tpu_torch/csrc/onesweep.cu",
         "replaces": "experiments/radix_write.py:318",
         "launches": words_counts["onesweep_pass"],
         "harness_launches": harness_counts["onesweep_pass"],
         "sharded_launches": sharded_launches["onesweep_pass"],
         "mp_launches": mp_launches["onesweep_pass"],
         "headline_launches": headline_counts["onesweep_pass"],
         "max_abs_err": max(os_err["pass"], sort_err),
         "ms": one[3]["ms"], "plain_ms": one[3]["plain_ms"],
         **bound(2 * 3 * 4 * n + 256 * 4, 8 * n)},
        {"name": "block_digit_sort", "route": "cuda",
         "source": "hpc_suffix_array_tpu_torch/csrc/radix.cu",
         "replaces": "experiments/radix_write.py:213",
         "launches": words_counts["block_digit_sort"],
         "harness_launches": harness_counts["block_digit_sort"],
         "sharded_launches": sharded_launches["block_digit_sort"],
         "mp_launches": mp_launches["block_digit_sort"],
         "headline_launches": headline_counts["block_digit_sort"],
         "check_launches": one[3]["k23_launches"]["block_digit_sort"],
         "max_abs_err": radix_err["k2"],
         "ms": k23["k2_ms"], "plain_ms": k23["k2_plain_ms"],
         **bound(2 * 3 * 4 * n + tiles * 256 * 4, 8 * n)},
        {"name": "place_runs", "route": "cuda",
         "source": "hpc_suffix_array_tpu_torch/csrc/radix.cu",
         "replaces": "experiments/radix_write.py:318",
         "launches": words_counts["place_runs"],
         "harness_launches": harness_counts["place_runs"],
         "sharded_launches": sharded_launches["place_runs"],
         "mp_launches": mp_launches["place_runs"],
         "headline_launches": headline_counts["place_runs"],
         "check_launches": one[3]["k23_launches"]["place_runs"],
         "max_abs_err": radix_err["k3"],
         "ms": k23["k3_ms"], "plain_ms": k23["k3_plain_ms"],
         **bound(2 * 3 * 4 * n + 2 * tiles * 256 * 4, 4 * n)},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        sys.exit(mp_worker(sys.argv[2:]))
    sys.exit(main())
