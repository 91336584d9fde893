"""Multi-process CLI: the ``mpirun -np P`` analog on ``torch.distributed``.

Counterpart of ``hpc_suffix_array_tpu/cli_distributed.py``. Two
surfaces of ``sa-cli-torch``:

  * **worker**: ``sa-cli-torch FILE --distributed --processes P
    --process-id I --coordinator HOST:PORT [--devices-per-process D]``
    joins the process group (``parallel/multihost.py``), reads ONLY this
    process's block of the file (``mp_local_geometry``), builds SA and
    LCP with ``build_suffix_array_sharded_big_mp`` over the global mesh
    (the doubling builder plus the distributed LCP over the whole text
    where it refuses), finds the LRS by a global argmax reduction,
    validates on process 0 (the SA all-gathered, the native O(n)
    validator against the file) and prints the human report and the
    MPI-dialect STRUCTURED_RESULTS, with ``PATH``, from process 0. The
    flags may come from SA_NUM_PROCESSES / SA_PROCESS_ID /
    SA_COORDINATOR instead; without them the worker exits with 2.
  * **launcher**: ``sa-cli-torch FILE --spawn P`` starts P workers of
    this CLI on a free local port (or ``--coordinator``), streams
    process 0's output and returns the worst exit status; when one
    worker fails, the others are stopped.

``--device`` is the workers' device: ``cuda`` (process r on card r mod
the card count; NCCL, or gloo with ``SA_PG_BACKEND=gloo`` when several
processes share a card) or ``cpu`` (gloo). IMPLEMENTATION reads
``cuda_sharded_mp`` or ``torch_cpu_sharded_mp``. SA_TIME and LCP_TIME
start and end with a device sync and a barrier, so they cover every
process.
"""

from __future__ import annotations

import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

WORKER = [sys.executable, "-m", "hpc_suffix_array_tpu_torch.cli"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_argv(args, process_id: int, n_processes: int,
                coordinator: str) -> list[str]:
    """The command line of worker ``process_id`` for launcher ``args``."""
    argv = [args.input, "--distributed", "--processes", str(n_processes),
            "--process-id", str(process_id), "--coordinator", coordinator,
            "--devices-per-process", str(args.devices_per_process),
            "--device", args.device, "--dialect", args.dialect]
    for flag, on in (("--no-validate", args.no_validate),
                     ("--string", args.string),
                     ("--file", args.force_file)):
        if on:
            argv.append(flag)
    return argv


def run_workers(cmds: list[list[str]], stdout=None, env=None,
                timeout: float | None = None) -> int:
    """Run one process per command and wait for all of them.

    Process 0's standard output goes to ``stdout`` (default: this
    process's), the others' is dropped; standard error is inherited.
    When a process fails, the rest are killed: a process waiting in a
    collective for a dead peer would otherwise wait for the group's
    timeout. Returns 0, or the worst exit status: a death by signal
    counts as a failure (``Popen`` reports it negative), and a run past
    ``timeout`` seconds as 124."""
    procs = [subprocess.Popen(cmd, env=env,
                              stdout=stdout if i == 0 else
                              subprocess.DEVNULL)
             for i, cmd in enumerate(cmds)]
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                code = p.poll()
                if code is None:
                    continue
                pending.remove(p)
                if code:
                    rc = max(rc, abs(code), 1)
                    for q in pending:
                        q.kill()
            if pending and deadline is not None and (
                    time.monotonic() > deadline):
                rc = max(rc, 124)
                for q in pending:
                    q.kill()
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def spawn(args, worker: list[str] | None = None, stdout=None) -> int:
    """Launch ``args.spawn`` workers of this CLI (the mpirun analog) and
    return the worst exit status. ``worker``: the command that precedes
    each worker's arguments (default: ``python -m
    hpc_suffix_array_tpu_torch.cli``); ``stdout``: where process 0's
    output goes."""
    n_proc = int(args.spawn)
    coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    prefix = WORKER if worker is None else worker
    return run_workers([prefix + worker_argv(args, i, n_proc, coordinator)
                        for i in range(n_proc)], stdout=stdout)


def _text_source(args):
    """(is_file, literal bytes or None)."""
    from hpc_suffix_array_tpu_torch.cli import looks_like_file

    is_file = (args.force_file
               or (looks_like_file(args.input) and not args.string))
    return is_file, None if is_file else args.input.encode("utf-8")


def _read(args, literal, start: int, stop: int) -> np.ndarray:
    """Bytes [start, stop) of the input (file or literal)."""
    if literal is not None:
        return np.frombuffer(literal[start:stop], np.uint8)
    with open(args.input, "rb") as f:
        f.seek(start)
        return np.frombuffer(f.read(stop - start), np.uint8)


def _padded(whole: torch.Tensor, n_pad: int, fill: int, mesh) -> list:
    """A whole int array of n entries as a padded sharded array."""
    from hpc_suffix_array_tpu_torch.parallel.mesh import shard

    full = torch.full((n_pad,), fill, dtype=whole.dtype,
                      device=whole.device)
    full[:whole.shape[0]] = whole
    return shard(full, mesh)


def lrs_location(sa_pad: list, lcp_pad: list, n: int) -> tuple[int, int]:
    """(length, start) of the first-maximal LRS of padded sharded SA and
    LCP columns, by global reductions: the largest LCP among rows below
    ``n``, the first row that holds it, and the SA entry there. The same
    on every process."""
    from hpc_suffix_array_tpu_torch.parallel.mesh import (
        first_local, local_ids, pmax, pmin, psum)

    P = len(sa_pad)
    m = first_local(lcp_pad).shape[0]
    mine = local_ids(lcp_pad)
    best, row = [None] * P, [None] * P
    for me in mine:
        lcp = lcp_pad[me].to(torch.int64)
        g = torch.arange(me * m, (me + 1) * m, device=lcp.device)
        masked = torch.where(g < n, lcp, -1)
        j = torch.argmax(masked)
        best[me], row[me] = masked[j], g[j]
    top = pmax(best)
    first = pmin([None if b is None else
                  torch.where(b == t, r, torch.iinfo(torch.int64).max)
                  for b, t, r in zip(best, top, row)])
    at = [None] * P
    for me in mine:
        j = first[me] - me * m
        hit = (j >= 0) & (j < m)
        at[me] = torch.where(hit, sa_pad[me][j.clamp(0, m - 1)].long(), 0)
    start = psum(at)
    return int(first_local(top)), int(first_local(start))


def run_distributed(args, arrays: dict | None = None) -> int:
    """Worker body (one of P processes); returns its exit status.
    ``arrays``: optional dict that receives the padded sharded ``sa`` and
    ``lcp`` and the ``results`` dict."""
    n_proc = int(args.processes or os.environ.get("SA_NUM_PROCESSES", 0))
    pid = int(args.process_id if args.process_id is not None
              else os.environ.get("SA_PROCESS_ID", -1))
    coordinator = (args.coordinator or os.environ.get("SA_COORDINATOR")
                   or "127.0.0.1:12355")
    if n_proc <= 0 or pid < 0:
        print("Error: --distributed needs --processes/--process-id (or "
              "SA_NUM_PROCESSES/SA_PROCESS_ID), or use --spawn P",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    from hpc_suffix_array_tpu_torch.parallel.multihost import (
        initialize_distributed)

    initialize_distributed(coordinator, n_proc, pid, args.device)
    rc = _worker(args, n_proc, pid, arrays)
    dist.destroy_process_group()
    return rc


def _worker(args, n_proc: int, pid: int, arrays: dict | None) -> int:
    import torch.distributed as dist

    from hpc_suffix_array_tpu_torch import native
    from hpc_suffix_array_tpu_torch.cli import (
        _print_structured, implementation_name)
    from hpc_suffix_array_tpu_torch.device import synchronize
    from hpc_suffix_array_tpu_torch.parallel import (
        build_lcp_array_sharded, build_suffix_array_sharded)
    from hpc_suffix_array_tpu_torch.parallel.bigsort import (
        build_suffix_array_sharded_big_mp, mp_local_geometry)
    from hpc_suffix_array_tpu_torch.parallel.mesh import unshard
    from hpc_suffix_array_tpu_torch.parallel.multihost import (
        make_global_mesh, process_device)

    root = pid == 0
    out = sys.stdout if root else io.StringIO()
    device = process_device(args.device, pid)
    is_file, literal = _text_source(args)
    if is_file:
        try:
            n = os.path.getsize(args.input)
        except OSError as e:
            print(f"Error: Failed to read input file: {e}", file=sys.stderr)
            return 1
        filename = args.input
        print(f"Reading from file: {args.input}", file=out)
        print(f"Actual string length: {n}", file=out)
    else:
        n = len(literal)
        filename = "direct_string"
        print(f"Input string: {args.input}", file=out)
        print(f"String length: {n}", file=out)

    mesh = make_global_mesh(args.devices_per_process, args.device)
    print(f"mesh: {mesh.size} shards over {n_proc} process(es), "
          f"{args.devices_per_process} each; process 0 on {device}",
          file=out)
    n_pad, start, stop = mp_local_geometry(n, mesh)
    # Only [start, stop) of the text reaches this process.
    block = np.zeros(stop - start, np.uint8)
    take = max(0, min(n, stop) - start)
    block[:take] = _read(args, literal, start, start + take)

    def fence():
        synchronize(device)
        dist.barrier()

    fence()
    t0 = time.perf_counter()
    path = "sharded_msd_mp"
    try:
        sa_pad, lcp_pad = build_suffix_array_sharded_big_mp(
            block, n, mesh, want_lcp=True)
    except (NotImplementedError, ValueError):
        # Refused (or n < 8): the doubling builder and the distributed
        # LCP over the whole text, the JAX package's fallback.
        path = "sharded_doubling"
        full = _read(args, literal, 0, n)
        sa = build_suffix_array_sharded(full, mesh, msd=False)
        fence()
        t1 = time.perf_counter()
        lcp = build_lcp_array_sharded(full, sa, mesh)
        sa_pad = _padded(sa, n_pad, n, mesh)
        lcp_pad = _padded(lcp, n_pad, 0, mesh)
    else:
        fence()
        t1 = time.perf_counter()
    lrs_len, lrs_start = lrs_location(sa_pad, lcp_pad, n)
    fence()
    t2 = time.perf_counter()
    # The carried-keys build gives SA and LCP in one pass, timed as
    # SA_TIME; LCP_TIME is then the LRS reduction, as in the JAX CLI.
    sa_time, lcp_time, total_time = t1 - t0, t2 - t1, t2 - t0

    valid = None
    if not args.no_validate:
        # Every process joins the gather; process 0 checks the SA
        # against the input's bytes.
        sa_all = unshard(sa_pad)[:n].cpu().numpy()
        if root:
            valid = native.sa_validate(_read(args, literal, 0, n), sa_all)
        del sa_all

    print("\n=== RESULTS ===", file=out)
    if valid is not None:
        print(f"Valid suffix array: {'YES' if valid else 'NO'}", file=out)
    if lrs_len > 0:
        shown = bytes(_read(args, literal, lrs_start, lrs_start + lrs_len)
                      ).decode("utf-8", errors="replace")
        print(f"Longest repeated substring: '{shown}' "
              f"(length: {lrs_len})", file=out)
    else:
        print("No repeated substring found", file=out)
    print(f"Suffix array construction time: {sa_time:.6f} seconds",
          file=out)
    print(f"LCP construction + LRS search time: {lcp_time:.6f} seconds",
          file=out)
    print(f"Total execution time: {total_time:.6f} seconds", file=out)

    results = {
        "implementation": implementation_name(device, "sharded_mp"),
        "filename": filename,
        "file_size": n,
        "total_time": total_time,
        "sa_time": sa_time,
        "lcp_time": lcp_time,
        "processes": n_proc,
        "valid": valid,
        "lrs_length": lrs_len,
        "path": path,
    }
    if root:
        _print_structured(results, args.dialect, sys.stdout, mpi_path=True)
        sys.stdout.flush()
    if arrays is not None:
        arrays.update(sa=sa_pad, lcp=lcp_pad, results=results)
    return 1 if valid is False else 0
