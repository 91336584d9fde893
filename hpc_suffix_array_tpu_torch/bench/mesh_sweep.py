"""Mesh sweep of the corpus harness: P shards against one device.

Counterpart of ``hpc_suffix_array_tpu/bench/mesh_sweep.py``: the corpus
files (random, repetitive, DNA at each size, written under ``data_dir``
from seed 42 if missing) run on one device and on meshes of P = 2, 4
and 8 shards, then the comparative chart and the multi-backend report.

    python -m hpc_suffix_array_tpu_torch.bench.mesh_sweep [sizes_mb ...]
        [--device cuda|cpu] [--out-dir DIR] [--data-dir DIR] [--no-charts]

Writes under ``out_dir`` (default results/benchmarks):
  * ``sequential_results_<platform>.csv``: this run's single-device
    rows, the speedup denominator;
  * ``parallel_results.csv``: ``<platform>_sharded_P`` rows with speedup
    and efficiency against those rows.

Honesty note: a machine with one card holds every shard on that card
(shard i sits on card i mod the card count), so the collectives are
copies or views on one device and the P shards take turns on it. These
rows then measure the sharded algorithm's own work (the P-way sort
network, the ring gathers) against the single-device builder, not an
interconnect, and speedup below 1 is what a perfect program shows
there. Rows where the single-device baseline took another builder are
flagged ``builder_mismatch`` (the carried-keys builders against the
sharded doubling loop). The charts need matplotlib; ``--no-charts``
skips them.
"""

from __future__ import annotations

import argparse
import pathlib

MB = 1 << 20
FAMILIES = ("random", "repetitive", "dna")


def main(sizes_mb=(1, 4), out_dir="results/benchmarks",
         data_dir="test_data", mesh_sizes=(None, 2, 4, 8), device="cuda",
         families=FAMILIES, charts: bool = True,
         verbose: bool = True) -> list[dict]:
    """Run the sweep; returns the harness rows."""
    from hpc_suffix_array_tpu_torch.bench.harness import benchmark_corpora
    from hpc_suffix_array_tpu_torch.datasets.generate import (
        generate_dna_text, generate_random_text, generate_repetitive_text)
    from hpc_suffix_array_tpu_torch.device import resolve_device
    from hpc_suffix_array_tpu_torch.viz.report import (
        generate_multi_backend_report)

    dev = resolve_device(device)
    gens = {"random": generate_random_text,
            "repetitive": generate_repetitive_text,
            "dna": generate_dna_text}
    data = pathlib.Path(data_dir)
    data.mkdir(parents=True, exist_ok=True)
    files = []
    for mb in sizes_mb:
        for fam in families:
            p = data / f"{fam}_{mb}MB.txt"
            if not p.exists():
                p.write_bytes(gens[fam](mb * MB, seed=42).tobytes())
            files.append(p)

    rows = benchmark_corpora(
        files, results_dir=out_dir, device=dev, verbose=verbose,
        mesh_sizes=tuple(mesh_sizes),
        seq_csv_name=f"sequential_results_{dev.type}.csv")
    charts_dir = pathlib.Path(out_dir) / "charts"
    if charts:
        from hpc_suffix_array_tpu_torch.viz.charts import (
            generate_comparative_charts)
        generate_comparative_charts(out_dir, charts_dir)
    generate_multi_backend_report(
        out_dir, charts_dir / "multi_backend_report.txt")
    return rows


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mesh_sweep", description="corpus sweep on one device and on "
                                       "meshes of 2, 4 and 8 shards")
    p.add_argument("sizes_mb", type=int, nargs="*", default=[1, 4])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default="results/benchmarks")
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--no-charts", action="store_true")
    args = p.parse_args(argv)
    rows = main(tuple(args.sizes_mb), args.out_dir, args.data_dir,
                device=args.device, charts=not args.no_charts)
    return 0 if all(r["success"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(cli())
