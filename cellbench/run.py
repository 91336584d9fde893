"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Makes the cell's texts from the seed, builds one text of each size to
warm up, builds back to back for ``--seconds`` (``harness.py``), judges
a seeded sample of the builds against the plain reference
(``reference.py``), and
prints the compared numbers beside their limits as the last lines of
standard error and one JSON result as the last line of standard output.
Exits nonzero, printing no result, without the CUDA cards the cell asks
for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout, so that
# only a checkout's first run builds.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cellbench" / sub)
    # This directory would shadow top-level modules; the checkout's root
    # holds the port and this package.
    sys.path[0] = str(ROOT)

    import torch

    from cellbench import harness

    bench = harness.Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 1
    api = harness.port_api()
    result, checked = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", T_START, api=api)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in the run's process: {', '.join(banned)}",
              file=sys.stderr)
        return 1
    print(f"judged {len(checked)} builds: {', '.join(checked)}",
          file=sys.stderr)
    print("\n".join(harness.check_lines(result)), file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
