"""Hand-written Hopper kernels (``csrc/``), each beside its plain version.

Kernels build with nvcc at first use (``_build.load``), never at import.
Each wrapper counts its own launches (``fn.launches``);
``launch_counts`` reads them all and ``reset_launch_counts`` zeroes
them.
"""

from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference, pack_words, pack_words_reference)
from hpc_suffix_array_tpu_torch.kernels.radix import (
    block_digit_sort, block_digit_sort_reference, digit_histograms,
    digit_histograms_reference, onesweep_pass, onesweep_pass_reference,
    place_runs, place_runs_reference, radix_sort_words,
    radix_sort_words_reference)

COUNTED = (pack_ranks, pack_words, digit_histograms, onesweep_pass,
           block_digit_sort, place_runs)


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    return {fn.__name__: fn.launches for fn in COUNTED}


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


__all__ = ["launch_counts", "reset_launch_counts", "pack_ranks", "pack_ranks_reference", "pack_words",
           "pack_words_reference", "block_digit_sort",
           "block_digit_sort_reference", "digit_histograms",
           "digit_histograms_reference", "onesweep_pass",
           "onesweep_pass_reference", "place_runs",
           "place_runs_reference", "radix_sort_words",
           "radix_sort_words_reference"]
