"""Hand-written Hopper kernels (``csrc/``), each beside its plain version.

Kernels build with nvcc at first use (``_build.load``), never at import.
"""

from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference, pack_words, pack_words_reference)
from hpc_suffix_array_tpu_torch.kernels.radix import (
    block_digit_sort, block_digit_sort_reference, digit_histograms,
    digit_histograms_reference, onesweep_pass, onesweep_pass_reference,
    place_runs, place_runs_reference, radix_sort_words,
    radix_sort_words_reference)

__all__ = ["pack_ranks", "pack_ranks_reference", "pack_words",
           "pack_words_reference", "block_digit_sort",
           "block_digit_sort_reference", "digit_histograms",
           "digit_histograms_reference", "onesweep_pass",
           "onesweep_pass_reference", "place_runs",
           "place_runs_reference", "radix_sort_words",
           "radix_sort_words_reference"]
