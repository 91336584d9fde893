"""Weak-scaling runner: n grows with the shard count, on one card.

Counterpart of ``hpc_suffix_array_tpu/bench/weak_scaling.py``, which
sweeps a virtual CPU mesh as a proxy for multi-chip scaling. Here every
shard sits on the one card (or the CPU), so the curves measure the
sharded algorithm's own overhead (the compare-split merges, the
collectives, the pad rows) at constant work per shard, never an
interconnect; the rows say so in ``scaling_mode``.

    python -m hpc_suffix_array_tpu_torch.bench.weak_scaling \\
        [BYTES_PER_SHARD] [--device cuda|cpu] [--out-dir DIR] [--no-charts]

Each build variant is swept on its own over P = 1, 2, 4 and 8 shards
(``bench/harness.py::weak_scaling_proxy``): ``msd`` (the carried-keys
pipeline), ``msd_lcp`` (its fused SA+LCP build alone), ``msd_wide`` (the
same with int64 indices) and ``doubling``. Then ``msd_2proc``: the
multi-process entry (``build_suffix_array_sharded_big_mp``) as real
processes through ``weak_scaling_worker.py``, 1 process x 1 shard and
then 2 processes x 2 shards, each process holding only its block of
the text, joined by gloo (``SA_PG_BACKEND=gloo``: two processes share a
card that NCCL would refuse them), so every crossing between the two
processes is staged through host memory.

Writes under ``DIR`` (default results/weak_scaling): ``weak_scaling.csv``
(one row per builder and P, with ``weak_efficiency`` t1/tP and
``weak_efficiency_normalized`` P*t1/tP), ``weak_scaling.txt`` (the same
numbers as text) and, unless ``--no-charts`` (the card's machine has no
matplotlib), ``weak_scaling.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

BUILDERS = ("msd", "msd_lcp", "msd_wide", "doubling")
MB = 1 << 20


def two_proc_mode(device) -> str:
    """The ``scaling_mode`` of the multi-process rows."""
    from hpc_suffix_array_tpu_torch.device import resolve_device

    where = "one_card" if resolve_device(device).type == "cuda" else "cpu"
    return f"weak_2proc_{where}_gloo"


def _distributed_point(bytes_per_shard: int, device, out_dir) -> list[dict]:
    """The ``msd_2proc`` rows: ``weak_scaling_worker.py`` at 1 process x
    1 shard (t1), then 2 processes x 2 shards (tP). Raises RuntimeError
    when a worker fails."""
    from hpc_suffix_array_tpu_torch.cli_distributed import run_workers

    worker = pathlib.Path(__file__).with_name("weak_scaling_worker.py")
    out_dir = pathlib.Path(out_dir).resolve()    # a file:// URL's path

    def launch(nprocs: int, dpp: int) -> dict:
        tag = f"{nprocs}x{dpp}"
        store = out_dir / f"pg_store_{tag}"
        store.unlink(missing_ok=True)
        env = {**os.environ, "SA_PG_BACKEND": "gloo"}
        cmds = [[sys.executable, str(worker), str(i), str(nprocs),
                 f"file://{store}", str(bytes_per_shard), str(dpp),
                 "--device", str(device)] for i in range(nprocs)]
        log = out_dir / f"worker_{tag}.out"
        with open(log, "w") as f:
            rc = run_workers(cmds, stdout=f, env=env, timeout=1200)
        store.unlink(missing_ok=True)
        if rc:
            raise RuntimeError(f"weak-scaling worker {tag} failed (exit "
                               f"{rc}); see {log}")
        return json.loads(log.read_text().strip().splitlines()[-1])

    r1, rP = launch(1, 1), launch(2, 2)
    t1 = r1["sa_time"]
    rows = []
    for r in (r1, rP):
        p, dt, n = r["P"], r["sa_time"], r["n"]
        rows.append({
            "file": f"weak_random_{p}shard", "size_bytes": n,
            "size_mb": n / MB, "backend": f"{r['nprocs']}proc_sharded_{p}",
            "platform": str(device), "processes": p, "time_seconds": dt,
            "throughput_mb_s": n / MB / dt if dt > 0 else 0,
            "sa_time": dt, "total_time": dt, "lcp_time": 0.0,
            "lrs_time": 0.0, "compile_time": 0.0, "success": True,
            "error": "", "scaling_mode": two_proc_mode(device),
            "builder": "msd_2proc", "nprocs": r["nprocs"],
            "peak_bytes": r["peak_bytes"],
            "launches": json.dumps(r["launches"], sort_keys=True),
            "weak_efficiency": t1 / dt if dt > 0 else 0.0,
            "weak_efficiency_normalized": p * t1 / dt if dt > 0 else 0.0,
        })
    print(f"weak-scaling[msd_2proc] P={rP['P']} (2 processes x 2 shards) "
          f"t1={t1:.4f}s tP={rP['sa_time']:.4f}s eff_norm="
          f"{rows[1]['weak_efficiency_normalized']:.3f}")
    return rows


def _report(rows: list[dict], bytes_per_shard: int, where: str) -> str:
    lines = [f"WEAK SCALING, every shard on {where} (see the module doc)",
             f"bytes/shard: {bytes_per_shard} "
             f"({bytes_per_shard / MB:.0f} MiB)", ""]
    for builder in dict.fromkeys(r["builder"] for r in rows):
        lines.append(f"[{builder}]")
        for r in (r for r in rows if r["builder"] == builder):
            lines.append(
                f"  P={int(r['processes'])}  n={int(r['size_bytes'])}  "
                f"sa_time={float(r['sa_time']):.4f}s  eff_norm(P*t1/tP)="
                f"{100 * float(r['weak_efficiency_normalized']):.1f}%  "
                f"eff_raw(t1/tP)={100 * float(r['weak_efficiency']):.1f}%")
        lines.append("")
    lines.append("NOTE: all shards share one device, so eff_raw is near 1/P "
                 "even at zero\noverhead; eff_norm is the sharded "
                 "algorithm's overhead. No interconnect\nis measured.")
    return "\n".join(lines)


def _chart(rows: list[dict], path, bytes_per_shard: int, where: str):
    from hpc_suffix_array_tpu_torch.viz.charts import _pyplot

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5.5))
    for builder in dict.fromkeys(r["builder"] for r in rows):
        g = [r for r in rows if r["builder"] == builder]
        ax.plot([int(r["processes"]) for r in g],
                [100 * float(r["weak_efficiency_normalized"]) for r in g],
                "o-", label=f"{builder} (P*t1/tP)")
    ax.axhline(70, color="tab:red", ls="--", lw=1, label="70%")
    ax.set_xscale("log", base=2)
    ax.set_xlabel("shards P")
    ax.set_ylabel("weak-scaling efficiency %  (P*t1/tP, n = P x "
                  f"{bytes_per_shard // MB} MiB)")
    ax.set_ylim(0, 115)
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(f"Weak scaling, every shard on {where} (algorithm "
                 "overhead, no interconnect)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(bytes_per_shard: int = 1 << 21, mesh_sizes=(1, 2, 4, 8),
         out_dir="results/weak_scaling", device="cuda", charts: bool = True,
         builders=BUILDERS, verbose: bool = True) -> list[dict]:
    """Run the sweep and the two-process point; write the CSV, the text
    report and (``charts``) the chart; return the rows."""
    import torch

    from hpc_suffix_array_tpu_torch.bench.harness import (
        _write_rows, weak_scaling_proxy)
    from hpc_suffix_array_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for builder in builders:
        got = weak_scaling_proxy(bytes_per_shard, mesh_sizes,
                                 results_dir=out, builder=builder,
                                 device=dev, verbose=verbose)
        rows += [r for r in got if r.get("builder") == builder
                 and r.get("scaling_mode")]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rows += _distributed_point(bytes_per_shard, dev.type, out)
    _write_rows(out / "weak_scaling.csv", rows)
    text = _report(rows, bytes_per_shard, where)
    (out / "weak_scaling.txt").write_text(text)
    if charts:
        _chart(rows, out / "weak_scaling.png", bytes_per_shard, where)
    if verbose:
        print(text)
    return rows


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="weak_scaling", description="weak-scaling sweep of the sharded "
                                         "builders on one device")
    p.add_argument("bytes_per_shard", type=int, nargs="?", default=1 << 21)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default="results/weak_scaling")
    p.add_argument("--no-charts", action="store_true")
    args = p.parse_args(argv)
    main(args.bytes_per_shard, out_dir=args.out_dir, device=args.device,
         charts=not args.no_charts)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
