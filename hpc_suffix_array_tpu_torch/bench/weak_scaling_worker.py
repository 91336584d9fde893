"""Timed worker of the multi-process weak-scaling point.

Counterpart of ``hpc_suffix_array_tpu/bench/weak_scaling_worker.py``:
one of ``nprocs`` processes joined by ``torch.distributed``, each
holding only its block of the text, builds with
``build_suffix_array_sharded_big_mp``.

    python weak_scaling_worker.py PROC_ID NPROCS COORDINATOR \\
        BYTES_PER_SHARD DEVICES_PER_PROC [--device cuda|cpu] \\
        [--corpus random|repetitive|dna] [--seed S] [--lcp] [--out DIR] \\
        [--trace DIR]

n = BYTES_PER_SHARD * NPROCS * DEVICES_PER_PROC (weak scaling: the work
per shard is constant). ``COORDINATOR`` is ``host:port`` or an init URL
(``file:///path``); the backend follows ``parallel/multihost.py::
pg_backend`` (``SA_PG_BACKEND=gloo`` for processes that share a card).
Each process makes the corpus from the seed and keeps only its block;
after a warm-up, the launch counts and the peak are reset, and one build
is timed between two barriers (each process syncs its device first).
``--lcp`` builds the LCP too. Process 0 prints one JSON line: ``sa_time``
(s), ``P``, ``nprocs``, ``n``, ``launches`` (its own), ``peak_bytes``.
``--out DIR``: every process also writes its local shards of the timed
build's padded SA (and LCP) as ``DIR/sa.<shard>.npy`` (``lcp.<shard>``)
and its numbers as ``DIR/rank<r>.json``. ``--trace DIR``: one more build,
which process 0 traces (``utils.profiling.device_trace``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="weak_scaling_worker")
    p.add_argument("proc_id", type=int)
    p.add_argument("nprocs", type=int)
    p.add_argument("coordinator")
    p.add_argument("bytes_per_shard", type=int)
    p.add_argument("devices_per_proc", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--corpus", default="random",
                   choices=["random", "repetitive", "dna"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lcp", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--trace", default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from hpc_suffix_array_tpu_torch.bench.harness import _fence_tree
    from hpc_suffix_array_tpu_torch.datasets import generate
    from hpc_suffix_array_tpu_torch.device import synchronize
    from hpc_suffix_array_tpu_torch.kernels import (
        launch_counts, reset_launch_counts)
    from hpc_suffix_array_tpu_torch.parallel.bigsort import (
        build_suffix_array_sharded_big_mp, mp_local_geometry)
    from hpc_suffix_array_tpu_torch.parallel.multihost import (
        initialize_distributed, make_global_mesh, process_device)

    initialize_distributed(args.coordinator, args.nprocs, args.proc_id,
                           args.device)
    mesh = make_global_mesh(args.devices_per_proc, args.device)
    dev = process_device(args.device, args.proc_id)
    n = args.bytes_per_shard * mesh.size

    make = {"random": generate.generate_random_text,
            "repetitive": generate.generate_repetitive_text,
            "dna": generate.generate_dna_text}[args.corpus]
    text = make(n, seed=args.seed)
    n_pad, start, stop = mp_local_geometry(n, mesh)
    local = np.zeros(stop - start, np.uint8)
    take = max(0, min(n, stop) - start)
    local[:take] = text[start:start + take]
    del text                    # a deployment reads only its own block

    def run():
        out = build_suffix_array_sharded_big_mp(local, n, mesh,
                                                want_lcp=args.lcp)
        _fence_tree(out)
        return out

    def fence():
        synchronize(dev)
        dist.barrier()

    run()                                           # warm-up
    fence()
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fence()
    t0 = time.perf_counter()
    out = run()
    fence()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    report = {"sa_time": dt, "P": mesh.size, "nprocs": args.nprocs, "n": n,
              "launches": counts, "peak_bytes": peak}
    if args.out:
        d = pathlib.Path(args.out)
        d.mkdir(parents=True, exist_ok=True)
        sa, lcp = out if args.lcp else (out, None)
        for me in mesh.local_ids:
            np.save(d / f"sa.{me}.npy", sa[me].cpu().numpy())
            if lcp is not None:
                np.save(d / f"lcp.{me}.npy", lcp[me].cpu().numpy())
        (d / f"rank{args.proc_id}.json").write_text(json.dumps(report))
    del out
    if args.trace:
        from hpc_suffix_array_tpu_torch.utils.profiling import device_trace

        if args.proc_id == 0:
            with device_trace(args.trace, dev):
                run()
        else:
            run()
        fence()
    if args.proc_id == 0:
        print(json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
