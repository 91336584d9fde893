"""Measurements of the MSD bucket builder, of the validator the CLI
runs after it, and sweeps and traces of whole builds through the bench
harness, on one CUDA card.

    python hpc_suffix_array_tpu_torch/msd_probe.py MODE [MODE ...]

Run from the repository root (``PYTHONPATH=.``). Every line printed
starts with the mode and ends with the card's name and power limit.
Modes:

  check     MSD at 2^24 (alnum, DNA, p1000, words; 4+ chunks, 8+
            buckets) against host SA-IS/Kasai, and 2^28 random alnum
            MSD against direct, byte for byte;
  cross     warm ``build_sa_lcp`` at 2^26, 2^27 and 2^28 random alnum,
            direct against MSD (``SA_DIRECT_CROSS`` 2^28 and 0), in the
            order direct, MSD, MSD, direct, twice;
  geometry  MSD ``build_sa_lcp`` at 2^30 random alnum for chunk widths
            2^24-2^27 and target buckets 2^23-2^28 (two runs each),
            with the phase times, bucket count and peak memory;
  words30   ``cli.run`` on 2^30 bytes of words, validated, twice (the
            first run pays the first-use allocations): path, refinement
            members, times, peak;
  n31       ``build_sa_lcp`` at 2^31 - 1 random alnum: path, times,
            peak, and 2^16 sampled adjacent SA pairs checked on the host;
  route     warm ``build_sa_lcp`` at 2^30 random alnum on whatever
            route the importable package takes (point ``PYTHONPATH`` at
            a checkout of another commit to time its route);
  warm      warm ``build_sa_lcp`` on 2^28 words (direct route with
            refinement) and 2^30 random alnum (MSD, with its count and
            scatter phases), three runs each after a warm-up, on
            whatever package is importable (as ``route``);
  validate  the validator at 2^26, 2^28 and 2^30 random alnum with the
            build's SA and LCP alive (as in the CLI): the fused form and
            the chunked form at widths 2^24-2^27, each warmed once, then
            timed five times in alternating order (host clock, synced),
            with the peak above what was allocated before the call.

  sweep     through ``bench.harness``: twin rows (warm-up, then one timed
            run) of DNA, repetitive p1000 and words at 1,024 MB, each
            followed by a validated run; then ten timed ``run_benchmark``
            repeats after one warm-up at 256 MB and 1,024 MB random
            alnum, with the median, quartiles and range of the total
            and SA times. CSVs go to ``OUT/sweep``;
  small     ``run_benchmark`` at 2^22 and 2^23 bytes (random alnum, DNA,
            words) under four settings of the route thresholds: the
            defaults, the carried-keys SA from 0 bytes
            (``SA_BIG_THRESHOLD=0``) with PLCP, the fused SA+LCP build
            from 0 bytes (``SA_LCP_BIG_MIN=0`` too), and doubling + PLCP
            forced; one warm-up and three timed runs each;
  trace     ``utils.profiling.device_trace`` around one warm
            ``build_sa_lcp`` at 2^30 random alnum (MSD) and at 2^28
            words (direct, refinement): device busy and idle share of
            the window, the ten device operations with the most time and
            the ten longest idle gaps with the device operations around
            them and the host's events inside them. Each trace is
            written under ``OUT/trace``, read and removed.
  sharded   the sharded backend (``parallel/``) on P = 1, 2, 4 and 8
            shards of the one card, both SA+LCP routes: the
            carried-keys build (``build_sa_lcp_sharded``; a warm-up,
            then two timed runs) and the sharded doubling plus the
            distributed PLCP (``msd=False``, the LCP reroute held off;
            once), each with its peak (host clock, synced): at 2^28
            random alnum, with the sharded validator and the
            single-device doubling + PLCP beside them, and at 2^20,
            2^22 and 2^24 random alnum and p1000; then
            ``device_trace`` around the P = 4 carried-keys build at 2^28
            (busy and idle share, top device operations, longest idle
            gaps) and around the P = 4 distributed PLCP at 2^24.
  mp        the multi-process path: first one attempt at two NCCL ranks
            on the one card (an all_reduce from each, ``NCCL_DEBUG=WARN``),
            expected to be refused: how each rank ended (the all_reduce
            ran, an error exit, or no answer within 60 s and killed) and
            the last lines it wrote to stderr; then ``bench/weak_scaling_worker.py`` (the
            library entry ``build_suffix_array_sharded_big_mp`` with
            ``want_lcp``, a warm-up, then one timed build between
            barriers) at 1 process x 4 shards on NCCL, 2^28 random alnum
            (smoke phase 13a's geometry), and at 2 processes x 2 shards
            on gloo (13b's), 2^26 random alnum and p1000, beside 1
            process x 4 shards on gloo at 2^26 alnum and the
            single-process ``build_suffix_array_sharded_big`` on 4
            shards (a warm-up, then two runs) of the same texts, staged on
            the card; then a
            trace of one 2 x 2 gloo build at 2^26 alnum from process 0:
            busy and idle share, top device operations, and the host
            spans "gloo host stage" (count, total ms).

Texts are made on the card from a seeded ``torch.Generator`` (words on
the host, in batches) and copied to the host once
(``datasets/generate.py``). ``OUT`` is the directory named by the
environment variable ``SA_PROBE_OUT`` (default ``build/probe``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.datasets.generate import (
    device_random_text, generate_words_text_batched)

OUT = os.environ.get("SA_PROBE_OUT", "build/probe")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def say(mode: str, msg: str) -> None:
    print(f"[{mode}] {msg} ({CARD})", flush=True)


def alnum_text(n: int, seed: int = 0) -> np.ndarray:
    """Random alnum bytes made on the card, copied to the host once."""
    return device_random_text(n, seed, "cuda").cpu().numpy()


def timed_sa_lcp(text: np.ndarray, t: torch.Tensor, cross: str | None):
    """(seconds, info, sa, lcp) of one ``build_sa_lcp`` (host clock,
    synced), with ``SA_DIRECT_CROSS`` set to ``cross`` (None: unset)."""
    from hpc_suffix_array_tpu_torch.core.lcp import build_sa_lcp

    if cross is None:
        os.environ.pop("SA_DIRECT_CROSS", None)
    else:
        os.environ["SA_DIRECT_CROSS"] = cross
    info: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa, lcp = build_sa_lcp(text, device="cuda", info=info, text_dev=t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, info, sa, lcp


def gib(b: int) -> str:
    return f"{b / 2**30:.2f} GiB"


def mode_check() -> None:
    from hpc_suffix_array_tpu_torch import native
    from hpc_suffix_array_tpu_torch.core.bigsort import build_suffix_array_big
    from hpc_suffix_array_tpu_torch.datasets import (
        generate_dna_text, generate_random_text, generate_repetitive_text,
        generate_words_text)

    for name, gen in (("alnum", generate_random_text),
                      ("DNA", generate_dna_text),
                      ("p1000", generate_repetitive_text),
                      ("words", generate_words_text)):
        text = gen(1 << 24, 0)
        info: dict = {}
        sa, lcp = build_suffix_array_big(
            text, device="cuda", info=info, want_lcp=True,
            chunk_elems=1 << 22, target_bucket=1 << 21)
        want = native.sa_build(text)
        ok_sa = np.array_equal(sa.cpu().numpy(), want)
        ok_lcp = np.array_equal(lcp.cpu().numpy(),
                                native.lcp_kasai(text, want))
        say("check", f"MSD 2^24 {name}: SA == SA-IS {ok_sa}, LCP == Kasai "
                     f"{ok_lcp}; {json.dumps(info)}")
        if not (ok_sa and ok_lcp):
            raise AssertionError(f"MSD 2^24 {name} differs from SA-IS")
    text = alnum_text(1 << 28)
    t = torch.from_numpy(text).cuda()
    _, di, d_sa, d_lcp = timed_sa_lcp(text, t, None)
    _, mi, m_sa, m_lcp = timed_sa_lcp(text, t, "0")
    same = torch.equal(d_sa, m_sa) and torch.equal(d_lcp, m_lcp)
    say("check", f"2^28 alnum: {di['path']} vs {mi['path']}: SA and LCP "
                 f"equal {same}")
    if not same or (di["path"], mi["path"]) != ("direct", "msd"):
        raise AssertionError("2^28 MSD differs from direct")


def mode_cross() -> None:
    for k in (26, 27, 28):
        text = alnum_text(1 << k)
        t = torch.from_numpy(text).cuda()
        times = {"direct": [], "msd": []}
        timed_sa_lcp(text, t, None)                     # warm-up
        timed_sa_lcp(text, t, "0")
        for _ in range(2):
            for cross in (None, "0", "0", None):
                s, info, sa, lcp = timed_sa_lcp(text, t, cross)
                del sa, lcp
                times[info["path"]].append(round(s * 1e3, 2))
                if info["path"] == "msd":
                    phases = (info["n_buckets_run"], info["phase_host_s"],
                              info["phase_device_ms"])
        say("cross", f"n=2^{k} random alnum warm build_sa_lcp ms: direct "
                     f"{times['direct']}, msd {times['msd']}; last msd "
                     f"buckets, host phases s, device ms {phases}")
        del t
        torch.cuda.empty_cache()


def _msd_run(text, t, mode: str, what: str) -> None:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s, info, sa, lcp = timed_sa_lcp(text, t, "0")
    del sa, lcp
    peak = torch.cuda.max_memory_allocated()
    say(mode, f"{what}: {s * 1e3:.1f} ms, path {info['path']}, buckets "
              f"{info.get('n_buckets_run')}, host phases s "
              f"{json.dumps(info.get('phase_host_s'))}, device ms "
              f"{json.dumps(info.get('phase_device_ms'))}, peak {gib(peak)}")


def mode_geometry() -> None:
    text = alnum_text(1 << 30)
    t = torch.from_numpy(text).cuda()
    _msd_run(text, t, "geometry", "warm-up")
    for env, values in (("SA_CHUNK_ELEMS", (24, 25, 26, 27)),
                        ("SA_TARGET_BUCKET", (23, 24, 25, 26, 27, 28))):
        for k in values:
            os.environ[env] = str(1 << k)
            for rep in range(2):
                _msd_run(text, t, "geometry",
                         f"n=2^30 alnum {env}=2^{k} run {rep}")
            del os.environ[env]


def mode_words30() -> None:
    import io

    from hpc_suffix_array_tpu_torch.cli import run as cli_run

    t0 = time.perf_counter()
    text = generate_words_text_batched(1 << 30)
    say("words30", f"words 2^30 generated on the host in "
                   f"{time.perf_counter() - t0:.1f} s")
    # The first run pays the first-use allocations, the second is warm.
    for rep in ("first", "second"):
        torch.cuda.reset_peak_memory_stats()
        res = cli_run(text, "words_2^30", "cuda", validate=True,
                      dialect="sequential", out=io.StringIO())
        peak = torch.cuda.max_memory_allocated()
        keep = {k: res.get(k) for k in (
            "path", "valid", "sa_time", "lcp_time", "total_time", "declined",
            "refine_members", "refine_pieces", "refine_rounds",
            "refine_host_members", "refine_phase_s", "rerun")}
        say("words30", f"cli.run words 2^30, {rep} run: {json.dumps(keep)}; "
                       f"peak {gib(peak)}")


def mode_n31() -> None:
    from hpc_suffix_array_tpu_torch.core.residue import suffix_less

    n = (1 << 31) - 1
    text = alnum_text(n)
    t = torch.from_numpy(text).cuda()
    torch.cuda.reset_peak_memory_stats()
    s, info, sa, lcp = timed_sa_lcp(text, t, None)
    peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(0)
    js = rng.integers(1, n, 1 << 16)
    a = sa[torch.from_numpy(js - 1).cuda()].cpu().numpy()
    b = sa[torch.from_numpy(js).cuda()].cpu().numpy()
    ok = all(suffix_less(text, int(x), int(y), n) for x, y in zip(a, b))
    say("n31", f"build_sa_lcp n=2^31-1 alnum: {s:.3f} s, path "
               f"{info['path']}, buckets {info.get('n_buckets_run')}, "
               f"phases {json.dumps(info.get('phase_host_s'))}, peak "
               f"{gib(peak)}; 2^16 sampled adjacent pairs ordered: {ok}")


def mode_route() -> None:
    text = alnum_text(1 << 30)
    t = torch.from_numpy(text).cuda()
    for rep in range(3):
        torch.cuda.reset_peak_memory_stats()
        s, info, sa, lcp = timed_sa_lcp(text, t, None)
        del sa, lcp
        peak = torch.cuda.max_memory_allocated()
        say("route", f"n=2^30 alnum build_sa_lcp run {rep}: {s:.3f} s, "
                     f"path {info.get('path')}, peak {gib(peak)}")
        torch.cuda.empty_cache()


def mode_warm() -> None:
    from hpc_suffix_array_tpu_torch.datasets import generate_words_text

    for name, text in (("words 2^28", generate_words_text(1 << 28, 0)),
                       ("alnum 2^30", alnum_text(1 << 30))):
        t = torch.from_numpy(text).cuda()
        ms, phases = [], []
        for rep in range(4):
            s, info, sa, lcp = timed_sa_lcp(text, t, None)
            del sa, lcp
            if rep:
                ms.append(round(s * 1e3, 2))
                host = info.get("phase_host_s") or {}
                phases.append({k: round(host[k] * 1e3, 2)
                               for k in ("count", "scatter") if k in host})
        say("warm", f"{name} build_sa_lcp path {info.get('path')}: ms {ms}; "
                    f"MSD count/scatter ms {json.dumps(phases)}")
        del t
        torch.cuda.empty_cache()


def mode_validate() -> None:
    from hpc_suffix_array_tpu_torch.core import validate as tval
    from hpc_suffix_array_tpu_torch.core.lcp import build_sa_lcp

    for k in (26, 28, 30):
        n = 1 << k
        text = alnum_text(n)
        t = torch.from_numpy(text).cuda()
        sa, lcp = build_sa_lcp(text, device="cuda", text_dev=t)
        forms = [("fused", None)] + [(f"chunk 2^{c}", 1 << c)
                                     for c in (24, 25, 26, 27) if c <= k]

        def run(width):
            if width is None:
                return bool(tval.validate_kernel(t, sa))
            return tval.validate_chunked(t, sa, width)

        times = {name: [] for name, _ in forms}
        peaks = {}
        for rep in range(6):
            for name, width in (forms if rep % 2 else forms[::-1]):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ok = run(width)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                if not ok:
                    raise AssertionError(f"validate {name} rejected the SA")
                if rep:                       # rep 0 is the warm-up
                    times[name].append(round(dt, 2))
                peaks[name] = gib(torch.cuda.max_memory_allocated() - base)
        say("validate", f"n=2^{k} alnum, {gib(base)} allocated before "
                        f"(text, sa, lcp): ms {json.dumps(times)}; peak "
                        f"above that {json.dumps(peaks)}")
        del t, sa, lcp
        torch.cuda.empty_cache()


def _spread(xs) -> str:
    q = statistics.quantiles(xs, n=4)
    return (f"median {statistics.median(xs):.4f}, quartiles {q[0]:.4f}-"
            f"{q[2]:.4f}, range {min(xs):.4f}-{max(xs):.4f}")


def mode_sweep() -> None:
    from hpc_suffix_array_tpu_torch.bench.harness import (
        _twin_for_file, benchmark_corpora)
    from hpc_suffix_array_tpu_torch.bench.timing import run_benchmark

    out = f"{OUT}/sweep"
    names = ["dna_1024MB", "repetitive_1024MB", "words_1024MB"]
    for name in names:
        torch.cuda.reset_peak_memory_stats()
        (row,) = benchmark_corpora(
            [name], results_dir=out, device="cuda", verbose=False, twin=True,
            seq_csv_name=f"sequential_results_twin_{name}.csv")
        peak = torch.cuda.max_memory_allocated()
        keep = {k: row.get(k) for k in (
            "success", "error", "builder", "lrs_length", "total_time",
            "sa_time", "lcp_time", "lrs_time", "compile_time",
            "throughput_mb_s")}
        say("sweep", f"twin row {name}: {json.dumps(keep)}; peak {gib(peak)}")
        text, text_dev = _twin_for_file(name, "cuda")
        try:
            r = run_benchmark(text, device="cuda", validate=True,
                              warmup=False, text_dev=text_dev)
            say("sweep", f"validated run {name}: valid {r.valid}, builder "
                         f"{r.builder}, total {r.total_time:.4f} s, SA "
                         f"{r.sa_time:.4f} s")
        except Exception as e:      # recorded: a fault of the port
            say("sweep", f"validated run {name}: FAILED "
                         f"{type(e).__name__}: {str(e)[:300]}")
        del text, text_dev
        torch.cuda.empty_cache()
    for name in ("random_256MB", "random_1024MB"):
        text, text_dev = _twin_for_file(name, "cuda")
        first = run_benchmark(text, device="cuda", text_dev=text_dev)
        runs = [first] + [run_benchmark(text, device="cuda", warmup=False,
                                        text_dev=text_dev) for _ in range(9)]
        say("sweep", f"{name} x10 after one warm-up (first-use "
                     f"{first.compile_time:.4f} s), builder {first.builder}: "
                     f"total s {[round(r.total_time, 4) for r in runs]}: "
                     f"{_spread([r.total_time for r in runs])}; SA s "
                     f"{_spread([r.sa_time for r in runs])}; LRS s "
                     f"{_spread([r.lrs_time for r in runs])}")
        del text, text_dev
        torch.cuda.empty_cache()


def mode_small() -> None:
    from hpc_suffix_array_tpu_torch.bench.timing import run_benchmark
    from hpc_suffix_array_tpu_torch.datasets import (
        generate_dna_text, generate_random_text, generate_words_text)

    never = str(1 << 62)
    settings = {
        "defaults": {},
        "carried SA + PLCP": {"SA_BIG_THRESHOLD": "0"},
        "fused SA+LCP": {"SA_BIG_THRESHOLD": "0", "SA_LCP_BIG_MIN": "0"},
        "doubling + PLCP": {"SA_BIG_THRESHOLD": never,
                            "SA_LCP_BIG_MIN": never},
    }
    for k in (22, 23):
        for fam, gen in (("alnum", generate_random_text),
                         ("DNA", generate_dna_text),
                         ("words", generate_words_text)):
            text = gen(1 << k, 0)
            text_dev = torch.from_numpy(text).cuda()
            for label, env in settings.items():
                for key in ("SA_BIG_THRESHOLD", "SA_LCP_BIG_MIN"):
                    os.environ.pop(key, None)
                os.environ.update(env)
                runs = [run_benchmark(text, device="cuda", warmup=(i == 0),
                                      text_dev=text_dev) for i in range(3)]
                say("small", f"n=2^{k} {fam}, {label}: builder "
                             f"{runs[0].builder}; ms total/SA/LCP "
                             f"{[(round(r.total_time * 1e3, 2), round(r.sa_time * 1e3, 2), round(r.lcp_time * 1e3, 2)) for r in runs]}")
            for key in ("SA_BIG_THRESHOLD", "SA_LCP_BIG_MIN"):
                os.environ.pop(key, None)


def mode_trace() -> None:
    from hpc_suffix_array_tpu_torch.bench.harness import _twin_for_file
    from hpc_suffix_array_tpu_torch.utils.profiling import (
        device_busy, device_trace, read_trace)

    for name in ("random_1024MB", "words_256MB"):
        text, t = _twin_for_file(name, "cuda")
        warm, _, sa, lcp = timed_sa_lcp(text, t, None)
        del sa, lcp
        plain, info, sa, lcp = timed_sa_lcp(text, t, None)
        del sa, lcp
        out = f"{OUT}/trace/{name}"
        with device_trace(out, "cuda"):
            traced, info, sa, lcp = timed_sa_lcp(text, t, None)
        del sa, lcp
        busy = device_busy(read_trace(out), n_top=10, n_gaps=10)
        say("trace", f"{name} build_sa_lcp path {info['path']}: first run "
                     f"{warm:.4f} s, warm {plain:.4f} s, under the profiler "
                     f"{traced:.4f} s; {busy['n_events']} device events, "
                     f"window {busy['window_ms']:.2f} ms, busy "
                     f"{busy['busy_ms']:.2f} ms, idle share "
                     f"{busy['idle_share']:.4f}; host phases s "
                     f"{json.dumps(info.get('phase_host_s'))}")
        say("trace", f"{name} top device operations: "
                     f"{json.dumps(busy['top'])}")
        for g in busy["gaps"]:
            say("trace", f"{name} idle gap {json.dumps(g)}")
        os.remove(f"{out}/trace.json")      # tens of MiB, already read
        del t
        torch.cuda.empty_cache()


def _timed_peak(fn):
    """(seconds, peak bytes above the allocation before, result) of one
    synced call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base, out)


def _sharded_routes(t: torch.Tensor, p: int, tag: str,
                    warm: bool = True) -> None:
    """Both sharded SA+LCP routes on ``t`` over ``p`` shards of the card,
    timed (host clock, synced) with their peaks: the carried-keys build
    (``build_suffix_array_sharded_big`` with ``want_lcp``, what
    ``build_sa_lcp_sharded`` runs from 4 MiB, here at every size; a
    warm-up first when ``warm``, then two runs) and the sharded doubling
    plus the distributed PLCP (``msd=False``, the LCP reroute held off),
    once."""
    from hpc_suffix_array_tpu_torch.kernels import (
        pass_counts, reset_launch_counts)
    from hpc_suffix_array_tpu_torch.parallel import (
        build_lcp_array_sharded, build_suffix_array_sharded,
        build_suffix_array_sharded_big, make_mesh)

    mesh = make_mesh(p, devices=["cuda:0"])

    def carried(info=None):
        return build_suffix_array_sharded_big(t, mesh, want_lcp=True,
                                              info=info)

    if warm:
        carried()
    runs = []
    for _ in range(2):
        info: dict = {}
        reset_launch_counts()
        s, peak, out = _timed_peak(lambda: carried(info))
        runs.append(f"{s:.4f}")
        del out
    say("sharded", f"{tag} P={p} carried keys: chain "
                   f"{info.get('chain_mode')}, words {info.get('n_words')}, "
                   f"sorts {info.get('msd_sorts')}, radix passes run "
                   f"{pass_counts()['passes_run']}; SA+LCP s {runs}; peak "
                   f"{gib(peak)}")
    torch.cuda.empty_cache()
    info = {}
    sa_s, sa_peak, sa = _timed_peak(
        lambda: build_suffix_array_sharded(t, mesh, info=info, msd=False))
    os.environ["SA_LCP_BIG_MIN"] = str(1 << 40)
    lcp_s, lcp_peak, _ = _timed_peak(
        lambda: build_lcp_array_sharded(t, sa, mesh, info=info))
    os.environ.pop("SA_LCP_BIG_MIN")
    say("sharded", f"{tag} P={p} doubling + PLCP: rounds {info['rounds']}, "
                   f"PLCP rounds {info['plcp_rounds']}; SA {sa_s:.4f} s peak "
                   f"{gib(sa_peak)}; PLCP {lcp_s:.4f} s peak {gib(lcp_peak)}; "
                   f"total {sa_s + lcp_s:.4f} s")
    del sa
    torch.cuda.empty_cache()


def mode_sharded() -> None:
    from hpc_suffix_array_tpu_torch.core.lcp import (
        lcp_from_plcp, plcp_kernel)
    from hpc_suffix_array_tpu_torch.core.suffix_array import (
        build_suffix_array_doubling)
    from hpc_suffix_array_tpu_torch.datasets.generate import (
        device_repetitive_text)
    from hpc_suffix_array_tpu_torch.parallel import (
        build_lcp_array_sharded, build_sa_lcp_sharded,
        build_suffix_array_sharded, is_valid_suffix_array_sharded,
        make_mesh)
    from hpc_suffix_array_tpu_torch.utils.profiling import (
        device_busy, device_trace, read_trace)

    n = 1 << 28
    t = device_random_text(n, 0, "cuda")
    for p in (1, 2, 4, 8):
        _sharded_routes(t, p, "n=2^28 alnum")
        mesh = make_mesh(p, devices=["cuda:0"])
        sa = build_sa_lcp_sharded(t, mesh)[0]
        val_s, val_peak, ok = _timed_peak(
            lambda: is_valid_suffix_array_sharded(t, sa, mesh))
        say("sharded", f"n=2^28 alnum P={p}: validator {val_s:.4f} s "
                       f"({ok}) peak {gib(val_peak)}")
        del sa
        torch.cuda.empty_cache()
    info = {}
    sa_s, sa_peak, sa = _timed_peak(
        lambda: build_suffix_array_doubling(t, device="cuda", info=info))
    lcp_s, lcp_peak, _ = _timed_peak(
        lambda: lcp_from_plcp(plcp_kernel(t, sa)[0], sa))
    say("sharded", f"n=2^28 alnum single-device doubling: rounds "
                   f"{info['rounds']}; SA {sa_s:.4f} s peak {gib(sa_peak)}; "
                   f"PLCP {lcp_s:.4f} s peak {gib(lcp_peak)}")
    del sa
    torch.cuda.empty_cache()

    mesh = make_mesh(4, devices=["cuda:0"])
    out = f"{OUT}/trace/sharded"
    with device_trace(out, "cuda"):
        build_sa_lcp_sharded(t, mesh)
        torch.cuda.synchronize()
    busy = device_busy(read_trace(out), n_top=10, n_gaps=3)
    say("sharded", f"trace P=4 carried-keys SA+LCP n=2^28: "
                   f"{busy['n_events']} device events, window "
                   f"{busy['window_ms']:.2f} ms, busy {busy['busy_ms']:.2f} "
                   f"ms, idle share {busy['idle_share']:.4f}")
    say("sharded", f"trace P=4 carried keys top device operations: "
                   f"{json.dumps(busy['top'])}")
    say("sharded", f"trace P=4 carried keys longest idle gaps: "
                   f"{json.dumps(busy['gaps'])}")
    os.remove(f"{out}/trace.json")
    del t
    torch.cuda.empty_cache()

    # Both routes below 2^28: where the carried keys start to win
    # (SA_SHARDED_MSD_MIN, 4 MiB) and, on periodic text, the
    # deep-repeat gate (SA_SHARDED_CHAIN_MIN, 64 KiB).
    for log_n in (20, 22, 24):
        for name, make in (("alnum", device_random_text),
                           ("p1000", device_repetitive_text)):
            t = make(1 << log_n, 0, "cuda")
            for p in (1, 2, 4, 8):
                _sharded_routes(t, p, f"n=2^{log_n} {name}")
            del t

    # The distributed PLCP at 2^24 (its 2^28 trace holds over 10^5
    # launches).
    t = device_random_text(1 << 24, 0, "cuda")
    sa = build_suffix_array_sharded(t, mesh)
    os.environ["SA_LCP_BIG_MIN"] = str(1 << 40)
    build_lcp_array_sharded(t, sa, mesh)                  # warm-up
    with device_trace(out, "cuda"):
        build_lcp_array_sharded(t, sa, mesh)
        torch.cuda.synchronize()
    os.environ.pop("SA_LCP_BIG_MIN")
    busy = device_busy(read_trace(out), n_top=5, n_gaps=3)
    say("sharded", f"trace P=4 PLCP n=2^24: {busy['n_events']} device "
                   f"events, window {busy['window_ms']:.2f} ms, busy "
                   f"{busy['busy_ms']:.2f} ms, idle share "
                   f"{busy['idle_share']:.4f}; top "
                   f"{json.dumps(busy['top'])}")
    os.remove(f"{out}/trace.json")


NCCL_TWO_RANKS = r"""
import sys
import torch
import torch.distributed as dist
rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + store, rank=rank,
                        world_size=2, device_id=torch.device("cuda", 0))
x = torch.ones(4, device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("ALL_REDUCE_RAN", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def _nccl_two_ranks(out: str) -> None:
    """Two NCCL ranks on one card: the expected refusal, as each rank
    reports it."""
    store = os.path.abspath(f"{out}/nccl_two_ranks_store")
    if os.path.exists(store):
        os.remove(store)
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_TWO_RANKS, str(r),
                               store], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    deadline = time.monotonic() + 60
    for r, proc in enumerate(procs):
        try:
            so, se = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            how = ("the all_reduce ran" if "ALL_REDUCE_RAN" in so
                   else f"refused: exit {proc.returncode}")
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
            how = "no answer within 60 s (a hang), killed"
        tail = [ln.strip() for ln in se.splitlines() if ln.strip()][-4:]
        say("mp", f"two NCCL ranks on one card, rank {r}: {how}; stderr "
                  f"ends {json.dumps(tail)}")


def _mp_worker_run(out: str, tag: str, nprocs: int, dpp: int,
                   bytes_per_shard: int, corpus: str, gloo: bool,
                   trace: str | None = None) -> dict:
    """Process 0's report of ``bench/weak_scaling_worker.py`` (with
    ``--lcp``) on ``nprocs`` x ``dpp`` shards of the card."""
    from hpc_suffix_array_tpu_torch.bench import weak_scaling
    from hpc_suffix_array_tpu_torch.cli_distributed import run_workers

    worker = os.path.join(os.path.dirname(weak_scaling.__file__),
                          "weak_scaling_worker.py")
    store = os.path.abspath(f"{out}/store_{tag}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ)
    if gloo:
        env["SA_PG_BACKEND"] = "gloo"
    cmds = [[sys.executable, worker, str(i), str(nprocs), f"file://{store}",
             str(bytes_per_shard), str(dpp), "--device", "cuda", "--corpus",
             corpus, "--seed", "0", "--lcp"]
            + (["--trace", trace] if trace else []) for i in range(nprocs)]
    log = f"{out}/worker_{tag}.out"
    with open(log, "w") as f:
        rc = run_workers(cmds, stdout=f, env=env, timeout=900)
    if rc:
        raise RuntimeError(f"mp worker {tag} exited {rc}; see {log}")
    with open(log) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def mode_mp() -> None:
    from hpc_suffix_array_tpu_torch.datasets.generate import (
        generate_random_text, generate_repetitive_text)
    from hpc_suffix_array_tpu_torch.parallel import (
        build_suffix_array_sharded_big, make_mesh)
    from hpc_suffix_array_tpu_torch.utils.profiling import (
        device_busy, read_trace)

    out = f"{OUT}/mp"
    os.makedirs(out, exist_ok=True)
    _nccl_two_ranks(out)
    mesh = make_mesh(4, devices=["cuda:0"])
    runs = (("13a", 1, 4, 1 << 26, "random", False),
            ("13b_alnum", 2, 2, 1 << 24, "random", True),
            ("13b_p1000", 2, 2, 1 << 24, "repetitive", True),
            ("1x4_gloo_alnum", 1, 4, 1 << 24, "random", True))
    for tag, nprocs, dpp, per, corpus, gloo in runs:
        r = _mp_worker_run(out, tag, nprocs, dpp, per, corpus, gloo)
        say("mp", f"{tag}: {nprocs} process(es) x {dpp} shards, "
                  f"{'gloo' if gloo else 'nccl'}, n={r['n']} {corpus}: "
                  f"build_suffix_array_sharded_big_mp SA+LCP "
                  f"{r['sa_time']:.4f} s; process 0 peak "
                  f"{gib(r['peak_bytes'])}; process 0 launches "
                  f"{json.dumps(r['launches'])}")
    for per, corpus, make in ((1 << 26, "random", generate_random_text),
                              (1 << 24, "random", generate_random_text),
                              (1 << 24, "repetitive",
                               generate_repetitive_text)):
        text = torch.from_numpy(make(4 * per, 0)).cuda()
        build_suffix_array_sharded_big(text, mesh, want_lcp=True)
        times = []
        for _ in range(2):
            s, peak, res = _timed_peak(lambda: build_suffix_array_sharded_big(
                text, mesh, want_lcp=True))
            times.append(f"{s:.4f}")
            del res
        say("mp", f"one process, 4 shards, n={4 * per} {corpus}: "
                  f"build_suffix_array_sharded_big SA+LCP s {times}; peak "
                  f"{gib(peak)}")
        del text
        torch.cuda.empty_cache()
    trace = f"{out}/trace_gloo"
    _mp_worker_run(out, "trace", 2, 2, 1 << 24, "random", True, trace=trace)
    events = read_trace(trace)
    busy = device_busy(events, n_top=10, n_gaps=5)
    stages = [e for e in events if e["name"] == "gloo host stage"]
    say("mp", f"trace 2 x 2 gloo n=2^26 alnum (process 0): "
              f"{busy['n_events']} device events, window "
              f"{busy['window_ms']:.2f} ms, busy {busy['busy_ms']:.2f} ms, "
              f"idle share {busy['idle_share']:.4f}; 'gloo host stage' "
              f"spans {len(stages)}, {sum(e['dur'] for e in stages) / 1e3:.2f}"
              f" ms")
    say("mp", f"trace 2 x 2 gloo top device operations: "
              f"{json.dumps(busy['top'])}")
    say("mp", f"trace 2 x 2 gloo longest idle gaps: "
              f"{json.dumps(busy['gaps'])}")
    os.remove(f"{trace}/trace.json")


MODES = {"check": mode_check, "cross": mode_cross, "geometry": mode_geometry,
         "words30": mode_words30, "n31": mode_n31, "route": mode_route,
         "validate": mode_validate, "warm": mode_warm, "sweep": mode_sweep,
         "small": mode_small, "trace": mode_trace, "sharded": mode_sharded,
         "mp": mode_mp}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("msd_probe needs a CUDA card")
    CARD = card()
    for m in sys.argv[1:]:
        MODES[m]()
