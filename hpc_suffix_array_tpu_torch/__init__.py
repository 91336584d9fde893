"""PyTorch/CUDA port of the suffix-array framework.

The counterpart of ``hpc_suffix_array_tpu`` on an NVIDIA Hopper card:
the prefix-doubling builder (texts up to 4 MiB, and the fallback), the
direct carried-keys SA+LCP builder (above 4 MiB), the MSD bucket
builder (texts the direct route cannot hold), PLCP LCP array,
longest repeated substring and the O(n) validator. Hand-written CUDA
kernels carry the key folds (``csrc/pack.cu``) and the carried-keys
radix sort (``csrc/onesweep.cu``). ``parallel/`` is the sharded backend:
the same build, LCP and validator block-sharded over a mesh of P shards.
Every public function takes an explicit ``device`` (or a mesh); a CUDA
device that is missing raises. This package imports neither jax nor the
JAX package.
"""

from hpc_suffix_array_tpu_torch.core.bigsort import (
    build_suffix_array_big, build_suffix_array_direct)
from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array, build_sa_lcp
from hpc_suffix_array_tpu_torch.core.lrs import find_longest_repeated_substring
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    SuffixArray, build_suffix_array)
from hpc_suffix_array_tpu_torch.core.validate import is_valid_suffix_array

__version__ = "0.1.0"

__all__ = [
    "SuffixArray",
    "build_suffix_array",
    "build_suffix_array_big",
    "build_suffix_array_direct",
    "build_lcp_array",
    "build_sa_lcp",
    "find_longest_repeated_substring",
    "is_valid_suffix_array",
    "__version__",
]
