"""Hand-written Hopper kernels (``csrc/``), each beside its plain version.

Kernels build with nvcc at first use (``_build.load``), never at import.
"""

from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference)

__all__ = ["pack_ranks", "pack_ranks_reference"]
