"""Sharded execution: one process driving P shards.

Counterpart of ``hpc_suffix_array_tpu/parallel/`` (its single-process
``shard_map`` mesh): every array is block-sharded over a ``Mesh`` of P
shards (``parallel/mesh.py``), the shards sort with a block-bitonic
compare-split network on the port's radix sort, and the LCP array and
the validator run sharded too. No shard holds more than 2n/P records of
the sort, and no array is replicated.

The JAX package's sharded carried-keys builder (``parallel/bigsort.py``)
and its multi-process mesh (``parallel/multihost.py``) are not here yet.
"""

from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard, unshard)
from hpc_suffix_array_tpu_torch.parallel.doubling import (
    build_suffix_array_sharded, suffix_array_kernel_sharded)
from hpc_suffix_array_tpu_torch.parallel.lcp import build_lcp_array_sharded
from hpc_suffix_array_tpu_torch.parallel.validate import (
    is_valid_suffix_array_sharded)


def sharded_msd_min() -> int:
    """Texts above this many bytes (``SA_SHARDED_MSD_MIN``, 4 MiB, a
    threshold set on a TPU) take the fused router in the CLI."""
    import os

    return int(os.environ.get("SA_SHARDED_MSD_MIN", 1 << 22))


def build_sa_lcp_sharded(text, mesh=None, info: dict | None = None):
    """Sharded (suffix array, LCP array), the distributed counterpart of
    ``core/lcp.py::build_sa_lcp``.

    The JAX package first tries one carried-keys pass here (its
    ``parallel/bigsort.py``, ``want_lcp``) and falls back to the doubling
    builder plus the distributed LCP; this package has the fallback
    only, so every text takes it. ``info`` receives ``path``, ``rounds``
    and ``plcp_rounds``."""
    sa = build_suffix_array_sharded(text, mesh, info=info)
    return sa, build_lcp_array_sharded(text, sa, mesh, info=info)


__all__ = [
    "Mesh",
    "build_sa_lcp_sharded",
    "make_mesh",
    "shard",
    "unshard",
    "build_suffix_array_sharded",
    "suffix_array_kernel_sharded",
    "build_lcp_array_sharded",
    "is_valid_suffix_array_sharded",
    "sharded_msd_min",
]
