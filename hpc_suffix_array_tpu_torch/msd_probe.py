"""Measurements of the MSD bucket builder, and of the validator the CLI
runs after it, on one CUDA card.

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
  words30   ``cli.run`` on 2^30 bytes of words, validated: path,
            refinement members, times, peak;
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

Texts are made on the card from a seeded ``torch.Generator`` (words on
the host, in batches) and copied to the host once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def say(mode: str, msg: str) -> None:
    print(f"[{mode}] {msg} ({CARD})", flush=True)


def alnum_text(n: int, seed: int = 0) -> np.ndarray:
    """Random alnum bytes made on the card, copied to the host once."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, len(ALNUM), (n,), generator=g, device="cuda",
                          dtype=torch.uint8)
    lut = torch.from_numpy(ALNUM.copy()).cuda()
    return torch.cat([lut[codes[i:i + (1 << 28)].long()]
                      for i in range(0, n, 1 << 28)]).cpu().numpy()


def words_text(n: int, seed: int = 0, batch: int = 1 << 24) -> np.ndarray:
    """The words corpus's distribution (``datasets.generate_words_text``:
    the same vocabulary for the seed), drawn in batches of ``batch``
    words so the host holds a few GiB at 2^30."""
    rng = np.random.default_rng(seed)
    octaves = 14
    vocab_size = 1 << octaves
    lens = rng.integers(2, 10, vocab_size)
    tab = np.zeros((vocab_size, 10), np.uint8)
    for L in range(2, 10):
        rows = np.flatnonzero(lens == L)
        tab[rows[:, None], np.arange(L)[None, :]] = ALNUM[
            rng.integers(0, len(ALNUM), (len(rows), L))]
        tab[rows, L] = ord(" ")
    wl = (lens + 1).astype(np.int64)
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
    text = words_text(1 << 30)
    say("words30", f"words 2^30 generated on the host in "
                   f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    res = cli_run(text, "words_2^30", "cuda", validate=True,
                  dialect="sequential", out=buf)
    peak = torch.cuda.max_memory_allocated()
    keep = {k: res.get(k) for k in (
        "path", "valid", "sa_time", "lcp_time", "total_time", "declined",
        "refine_members", "refine_pieces", "refine_rounds",
        "refine_host_members", "refine_phase_s", "rerun")}
    say("words30", f"cli.run words 2^30: {json.dumps(keep)}; peak "
                   f"{gib(peak)}")


def mode_n31() -> None:
    from hpc_suffix_array_tpu_torch.core.bigsort import _suffix_less

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
    ok = all(_suffix_less(text, int(x), int(y), n) for x, y in zip(a, b))
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


MODES = {"check": mode_check, "cross": mode_cross, "geometry": mode_geometry,
         "words30": mode_words30, "n31": mode_n31, "route": mode_route,
         "validate": mode_validate, "warm": mode_warm}


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("msd_probe needs a CUDA card")
    CARD = card()
    for m in sys.argv[1:]:
        MODES[m]()
