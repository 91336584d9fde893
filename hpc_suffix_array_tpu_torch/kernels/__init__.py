"""Hand-written Hopper kernels (``csrc/``), each beside its plain version.

Kernels build with nvcc at first use (``_build.load``), never at import.
Each wrapper counts its own launches ("launches: <name>") and the radix
sort its executed and skipped passes in the recorder's process table
(``utils/profiling.py``); ``launch_counts`` and ``pass_counts`` read
them and ``reset_launch_counts`` zeroes them.
"""

from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference, pack_words, pack_words_reference)
from hpc_suffix_array_tpu_torch.kernels.radix import (
    block_digit_sort, block_digit_sort_reference, digit_histograms,
    digit_histograms_reference, onesweep_pass, onesweep_pass_reference,
    place_runs, place_runs_reference, radix_sort_words,
    radix_sort_words_reference)
from hpc_suffix_array_tpu_torch.utils.profiling import (
    process_counters, reset_counters)

COUNTED = ("pack_ranks", "pack_words", "digit_histograms", "onesweep_pass",
           "block_digit_sort", "place_runs", "post_sort", "refine_gather",
           "refine_split")
PASSES = ("passes_run", "passes_skipped")


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    counters = process_counters()
    return {name: counters.get(f"launches: {name}", 0) for name in COUNTED}


def pass_counts() -> dict[str, int]:
    """``radix_sort_words``' executed and skipped passes on CUDA since
    the last ``reset_launch_counts``."""
    counters = process_counters()
    return {name: counters.get(name, 0) for name in PASSES}


def reset_launch_counts() -> None:
    reset_counters(*(f"launches: {name}" for name in COUNTED), *PASSES)


__all__ = ["launch_counts", "pass_counts", "reset_launch_counts",
           "pack_ranks", "pack_ranks_reference", "pack_words",
           "pack_words_reference", "block_digit_sort",
           "block_digit_sort_reference", "digit_histograms",
           "digit_histograms_reference", "onesweep_pass",
           "onesweep_pass_reference", "place_runs",
           "place_runs_reference", "radix_sort_words",
           "radix_sort_words_reference"]
