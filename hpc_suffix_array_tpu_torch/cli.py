"""Command-line entry point of the port: ``sa-cli-torch``.

Counterpart of ``hpc_suffix_array_tpu/cli.py`` (its single-process
backends, ``--backend single`` and ``--backend sharded``):

  * one positional argument with the file-vs-string heuristic: an
    argument containing '/' or '.' is a file path, otherwise a literal
    string;
  * the human report (validity, LRS, per-phase times) and the n <= 100
    detail dump;
  * both STRUCTURED_RESULTS dialects (`===STRUCTURED_RESULTS===` and
    `--- STRUCTURED_RESULTS ---`), with PATH (the builder that served
    the request) and RERUN (a carried-keys build that re-ran in the
    other chain direction), and a FAILED block with a nonzero exit when
    a build fails;
  * above ``SA_LCP_BIG_MIN`` (8 MiB) one fused carried-keys SA+LCP build
    (``core/lcp.py::build_sa_lcp``), timed as the SA phase, as in the
    JAX CLI.

``--device`` defaults to ``cuda`` and raises when CUDA is unavailable;
``--device cpu`` runs the same path on the CPU. IMPLEMENTATION reads
``cuda`` on the card and ``torch_cpu`` on the CPU. ``--trace DIR`` wraps
the run in ``utils.profiling.device_trace`` and writes ``DIR/trace.json``.

``--distributed`` (one worker of a process group) and ``--spawn P`` (the
mpirun analog that starts P workers) run the multi-process path of
``cli_distributed.py``, with ``--processes``, ``--process-id``,
``--coordinator`` and ``--devices-per-process``.

Run as ``python -m hpc_suffix_array_tpu_torch.cli <file-or-string>``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from hpc_suffix_array_tpu_torch.device import resolve_device, synchronize
from hpc_suffix_array_tpu_torch.utils.io import (
    print_first_chars, print_last_chars, read_file)


def looks_like_file(arg: str) -> bool:
    """The reference's heuristic: '/' or '.' means file."""
    return "/" in arg or "." in arg


def implementation_name(device, backend: str = "single") -> str:
    """IMPLEMENTATION of a run: ``cuda`` or ``torch_cpu``, suffixed with
    the backend ("sharded", or "sharded_mp" for the multi-process CLI)
    unless it is "single"."""
    name = "cuda" if resolve_device(device).type == "cuda" else "torch_cpu"
    return name if backend == "single" else f"{name}_{backend}"


def _sync(devices) -> None:
    for d in devices:
        synchronize(d)


def run(text: np.ndarray, filename: str, device, validate: bool,
        dialect: str, out=None, arrays: dict | None = None,
        backend: str = "single", n_devices: int | None = None,
        mesh=None) -> dict:
    """Build SA + LCP + LRS with per-phase timing; print the full report.

    Returns the structured-results dict (also printed as text blocks),
    with the doubling and PLCP round counts, the carried-keys build's
    chain mode, word count and refinement keys where it ran
    (``declined`` where it fell back), and the LCP's route keys
    (``lcp_path``, ``lcp_misses``, ``lcp_finish``, ``lcp_declined``;
    see ``build_lcp_array``). ``arrays``: optional
    dict that receives the ``sa`` and ``lcp`` tensors.

    ``backend`` "sharded" builds over ``mesh`` (a ``parallel.Mesh``), or
    when it is None over ``make_mesh(n_devices, device=device)``: by
    default one shard per visible card."""
    from hpc_suffix_array_tpu_torch.core.lcp import (
        build_lcp_array, build_sa_lcp, lcp_big_min)
    from hpc_suffix_array_tpu_torch.core.lrs import (
        find_longest_repeated_substring)
    from hpc_suffix_array_tpu_torch.core.suffix_array import (
        as_byte_tensor, build_suffix_array)
    from hpc_suffix_array_tpu_torch.core.validate import is_valid_suffix_array

    out = out if out is not None else sys.stdout
    dev = resolve_device(device)
    n = int(text.shape[0])
    info: dict = {}
    devices = [dev]
    if backend == "sharded":
        from hpc_suffix_array_tpu_torch import parallel

        if mesh is None:
            mesh = parallel.make_mesh(n_devices, device=dev)
        dev, devices = mesh.devices[0], mesh.devices
        kind = "card(s)" if dev.type == "cuda" else f"{dev.type} device(s)"
        print(f"mesh: {mesh.size} shards on {mesh.n_cards} {kind}",
              file=out)
    elif mesh is not None:
        raise ValueError("a mesh needs backend='sharded'")

    _sync(devices)
    t0 = time.perf_counter()
    # The text is staged once, inside the SA phase as in the JAX CLI;
    # the single-device routers plan on the host bytes, the sharded
    # builders shard the staged copy.
    text_dev = as_byte_tensor(text, dev)
    combined = None
    if mesh is not None and n > parallel.sharded_msd_min():
        # The sharded fused router, as in the JAX CLI.
        combined = parallel.build_sa_lcp_sharded(text_dev, mesh, info=info)
        sa = combined[0]
    elif mesh is not None:
        sa = parallel.build_suffix_array_sharded(text_dev, mesh, info=info)
    elif n > lcp_big_min():
        # One carried-keys pass gives SA and LCP together; if it falls
        # back to doubling and PLCP, both land in the SA phase too.
        combined = build_sa_lcp(text, device=dev, info=info,
                                text_dev=text_dev)
        sa = combined[0]
    else:
        sa = build_suffix_array(text, device=dev, info=info,
                                text_dev=text_dev)
    _sync(devices)
    t1 = time.perf_counter()
    if combined is not None:
        lcp = combined[1]
    elif mesh is not None:
        lcp = parallel.build_lcp_array_sharded(text_dev, sa, mesh,
                                               info=info)
    else:
        lcp = build_lcp_array(text, sa, device=dev, info=info,
                              text_dev=text_dev)
    lrs = find_longest_repeated_substring(text_dev, sa, lcp, device=dev)
    _sync(devices)
    t2 = time.perf_counter()
    sa_time, lcp_time, total_time = t1 - t0, t2 - t1, t2 - t0

    if not validate:
        valid = None
    elif mesh is not None:
        valid = parallel.is_valid_suffix_array_sharded(text_dev, sa, mesh)
    else:
        valid = is_valid_suffix_array(text_dev, sa, device=dev)

    print("\n=== RESULTS ===", file=out)
    if validate:
        print(f"Valid suffix array: {'YES' if valid else 'NO'}", file=out)
    if lrs:
        shown = lrs.decode("utf-8", errors="replace")
        print(f"Longest repeated substring: '{shown}' (length: {len(lrs)})",
              file=out)
    else:
        print("No repeated substring found", file=out)
    print(f"Suffix array construction time: {sa_time:.6f} seconds", file=out)
    print(f"LCP construction + LRS search time: {lcp_time:.6f} seconds",
          file=out)
    print(f"Total execution time: {total_time:.6f} seconds", file=out)

    if n <= 100:
        _detail_dump(text, sa.cpu().numpy(), lcp.cpu().numpy(), out)

    results = {
        "implementation": implementation_name(dev, backend),
        "filename": filename,
        "file_size": n,
        "total_time": total_time,
        "sa_time": sa_time,
        "lcp_time": lcp_time,
        "processes": 1 if mesh is None else mesh.size,
        "valid": valid,
        "lrs_length": len(lrs) if lrs else 0,
        "rounds": info.get("rounds", 0),
        "plcp_rounds": info.get("plcp_rounds", 0),
    }
    for key in ("path", "chain_mode", "n_words", "declined",
                "refine_members", "refine_pieces", "refine_rounds",
                "refine_host_members", "refine_phase_s", "lcp_path",
                "lcp_misses", "lcp_finish", "lcp_declined"):
        if key in info:
            results[key] = info[key]
    if info.get("rerun"):
        # The reported SA_TIME includes the re-run build.
        results["rerun"] = ",".join(info["rerun"])
    if arrays is not None:
        arrays.update(sa=sa, lcp=lcp)
    _print_structured(results, dialect, out)
    return results


def _detail_dump(text: np.ndarray, sa: np.ndarray, lcp: np.ndarray, out):
    """Small-input detail block: the first SA entries and LCP values."""
    n = len(text)
    print("\n=== DETAILED ANALYSIS ===", file=out)
    print(f"Suffix array ({n} entries):", file=out)
    for j in range(min(n, 10)):
        s = bytes(text[sa[j]:sa[j] + 30]).decode("utf-8", errors="replace")
        ell = "..." if n - sa[j] > 30 else ""
        print(f'  sa[{j}] = {sa[j]:3d}  "{s}{ell}"', file=out)
    shown = ", ".join(str(int(v)) for v in lcp[:20])
    suffix = ", ..." if n > 20 else ""
    print(f"\nLCP Array: [{shown}{suffix}]", file=out)


def _print_structured(r: dict, dialect: str, out,
                      mpi_path: bool = False) -> None:
    """The STRUCTURED_RESULTS blocks of ``dialect``; ``mpi_path`` adds the
    PATH line to the MPI block too (the multi-process CLI's)."""
    if dialect in ("sequential", "both"):
        print("\n===STRUCTURED_RESULTS===", file=out)
        print(f"IMPLEMENTATION:{r['implementation']}", file=out)
        print(f"FILENAME:{r['filename']}", file=out)
        print(f"FILE_SIZE:{r['file_size']}", file=out)
        print(f"TOTAL_TIME:{r['total_time']:.6f}", file=out)
        print(f"SA_TIME:{r['sa_time']:.6f}", file=out)
        print(f"LCP_TIME:{r['lcp_time']:.6f}", file=out)
        print(f"PROCESSES:{r['processes']}", file=out)
        if r.get("path"):
            print(f"PATH:{r['path']}", file=out)
        if r.get("rerun"):
            print(f"RERUN:{r['rerun']}", file=out)
        print("===END_RESULTS===\n", file=out)
    if dialect in ("mpi", "both"):
        print("\n--- STRUCTURED_RESULTS ---", file=out)
        print(f"ACTUAL_STRING_LENGTH:{r['file_size']}", file=out)
        print(f"MPI_PROCESSES:{r['processes']}", file=out)
        print(f"SA_TIME:{r['sa_time']:.6f}", file=out)
        print(f"LCP_TIME:{r['lcp_time']:.6f}", file=out)
        print(f"TOTAL_TIME:{r['total_time']:.6f}", file=out)
        if mpi_path and r.get("path"):
            print(f"PATH:{r['path']}", file=out)
        if r.get("rerun"):
            print(f"RERUN:{r['rerun']}", file=out)
        print("--- END_STRUCTURED_RESULTS ---", file=out)


def build_parser() -> argparse.ArgumentParser:
    """The command line of ``sa-cli-torch`` (its multi-process workers
    take the same)."""
    p = argparse.ArgumentParser(
        prog="sa-cli-torch",
        description="Suffix array / LCP / LRS on one device or a mesh of "
                    "shards (PyTorch port)")
    p.add_argument("input",
                   help="input file path or literal string; an argument "
                        "containing '/' or '.' is treated as a file")
    p.add_argument("--device", default="cuda",
                   help="torch device to build on (default: cuda; raises "
                        "when CUDA is unavailable)")
    p.add_argument("--backend", choices=["single", "sharded"],
                   default="single",
                   help="single-device build or block-sharded build over "
                        "a mesh of shards")
    p.add_argument("--devices", type=int, default=None,
                   help="shards for --backend sharded (a power of two; "
                        "default: one per visible card; shard i sits on "
                        "card i mod the card count)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the O(n) self-validation pass")
    p.add_argument("--dialect", choices=["sequential", "mpi", "both"],
                   default=None,
                   help="STRUCTURED_RESULTS dialect to emit (default: "
                        "sequential; mpi under --distributed and --spawn)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process worker: join the process group and "
                        "build with each process reading only its block "
                        "of the text")
    p.add_argument("--spawn", type=int, metavar="P", default=None,
                   help="launcher (the mpirun analog): start P "
                        "--distributed workers and wait for them")
    p.add_argument("--processes", type=int, default=None,
                   help="process count for --distributed "
                        "(or SA_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --distributed "
                        "(or SA_PROCESS_ID)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the process group's store, served by "
                        "process 0, or an init URL such as file:///path "
                        "(or SA_COORDINATOR; --spawn picks a free local "
                        "port when it is not given)")
    p.add_argument("--devices-per-process", type=int, default=1,
                   help="shards per process under --distributed and "
                        "--spawn (a power of two over all processes)")
    p.add_argument("--string", action="store_true",
                   help="force the argument to be a literal string")
    p.add_argument("--file", dest="force_file", action="store_true",
                   help="force the argument to be a file path")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the run to "
                        "DIR/trace.json")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """``build_parser``'s arguments, with the dialect's default
    resolved: mpi under --distributed and --spawn, else sequential."""
    args = build_parser().parse_args(argv)
    if args.dialect is None:
        args.dialect = ("mpi" if args.distributed or args.spawn
                        else "sequential")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # Outside the FAILED handler: a missing device is a usage error, not
    # a build failure, and must never turn into a CPU run.
    device = resolve_device(args.device)
    if args.spawn:
        from hpc_suffix_array_tpu_torch.cli_distributed import spawn
        return spawn(args)
    if args.distributed:
        from hpc_suffix_array_tpu_torch.cli_distributed import (
            run_distributed)
        return run_distributed(args)
    mesh = None
    if args.backend == "sharded":
        from hpc_suffix_array_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.devices, device=device)

    is_file = (args.force_file
               or (looks_like_file(args.input) and not args.string))
    if is_file:
        print(f"Reading from file: {args.input}")
        try:
            text = read_file(args.input)
        except OSError as e:
            print(f"Error: Failed to read input file: {e}", file=sys.stderr)
            return 1
        filename = args.input
        n = len(text)
        print(f"File read successfully: {args.input}")
        print(f"Actual string length: {n}")
        if n < 100:
            content = bytes(text).decode("utf-8", errors="replace")
            print(f'Full content: "{content}"')
        else:
            print_first_chars(text, 50)
            print_last_chars(text, 50)
        print()
    else:
        text = np.frombuffer(args.input.encode("utf-8"), np.uint8)
        filename = "direct_string"
        print(f"Input string: {args.input}")
        print(f"String length: {len(text)}")

    try:
        if args.trace:
            from hpc_suffix_array_tpu_torch.utils.profiling import (
                device_trace)
            with device_trace(args.trace, device):
                run(text, filename, device, validate=not args.no_validate,
                    dialect=args.dialect, backend=args.backend, mesh=mesh)
            print(f"device trace written to {args.trace}")
        else:
            run(text, filename, device, validate=not args.no_validate,
                dialect=args.dialect, backend=args.backend, mesh=mesh)
    except KeyboardInterrupt:
        raise
    except Exception as e:
        # Boundary of the program: report an actionable error plus a
        # parseable FAILED block and exit nonzero, so a harness records
        # a FAILED row instead of a stack trace.
        msg = str(e).splitlines()[0][:200] if str(e) else ""
        print(f"Error: build failed: {type(e).__name__}: {msg}",
              file=sys.stderr)
        print("\n===STRUCTURED_RESULTS===")
        print(f"IMPLEMENTATION:{implementation_name(device, args.backend)}")
        print(f"FILENAME:{filename}")
        print(f"FILE_SIZE:{len(text)}")
        print("STATUS:FAILED")
        print(f"ERROR:{type(e).__name__}")
        print("===END_RESULTS===")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
