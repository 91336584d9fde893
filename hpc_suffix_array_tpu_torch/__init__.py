"""PyTorch/CUDA port of the suffix-array framework (single device).

The counterpart of ``hpc_suffix_array_tpu`` on an NVIDIA Hopper card:
prefix-doubling suffix array, PLCP LCP array, longest repeated
substring and the O(n) validator, with the packed-initial-rank fold as a
hand-written CUDA kernel (``csrc/pack.cu``). Every public function takes
an explicit ``device``; a CUDA device that is missing raises. This
package imports neither jax nor the JAX package.
"""

from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array
from hpc_suffix_array_tpu_torch.core.lrs import find_longest_repeated_substring
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    SuffixArray, build_suffix_array)
from hpc_suffix_array_tpu_torch.core.validate import is_valid_suffix_array

__version__ = "0.1.0"

__all__ = [
    "SuffixArray",
    "build_suffix_array",
    "build_lcp_array",
    "find_longest_repeated_substring",
    "is_valid_suffix_array",
    "__version__",
]
