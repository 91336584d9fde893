"""Sharded execution: one process driving P shards.

Counterpart of ``hpc_suffix_array_tpu/parallel/`` (its single-process
``shard_map`` mesh): every array is block-sharded over a ``Mesh`` of P
shards (``parallel/mesh.py``), the shards sort with a block-bitonic
compare-split network on the port's radix sort, and the LCP array and
the validator run sharded too. No shard holds more than 2n/P records of
the sort, and no array is replicated. Texts from 4 MiB, and deep-repeat
texts from 64 KiB, first try the sharded carried-keys builder
(``parallel/bigsort.py``): one distributed sort gives the SA and the
LCP.

The JAX package's multi-process mesh (``parallel/multihost.py``) and the
multi-process entry of its ``parallel/bigsort.py`` are not here yet.
"""

from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, padded_length, shard, unshard)
from hpc_suffix_array_tpu_torch.parallel.doubling import (
    build_suffix_array_sharded, suffix_array_kernel_sharded, text_length)
from hpc_suffix_array_tpu_torch.parallel.bigsort import (
    build_suffix_array_sharded_big, sharded_msd_min, try_carried_keys,
    wide_auto)
from hpc_suffix_array_tpu_torch.parallel.lcp import build_lcp_array_sharded
from hpc_suffix_array_tpu_torch.parallel.validate import (
    is_valid_suffix_array_sharded)


def build_sa_lcp_sharded(text, mesh=None, info: dict | None = None):
    """Sharded (suffix array, LCP array), the distributed counterpart of
    ``core/lcp.py::build_sa_lcp``.

    Behind the JAX package's gates (``try_carried_keys``) one
    carried-keys pass gives both (``build_suffix_array_sharded_big``,
    ``want_lcp``); a refusal falls back to the doubling builder, told not
    to try the same pass again (``msd=False``), plus the distributed LCP.
    ``info`` receives ``path`` and the builders' keys. Both arrays are
    int32: raises ValueError when the padded length reaches 2^31."""
    mesh = make_mesh() if mesh is None else mesh
    n = text_length(text)
    padded_length(n, mesh.size)      # int32 arrays: raises at 2^31
    msd = None
    if n >= 8 and try_carried_keys(text, n):
        try:
            out = build_suffix_array_sharded_big(text, mesh, want_lcp=True,
                                                 info=info)
        except NotImplementedError:
            msd = False
        else:
            if info is not None:
                info["path"] = "sharded_msd"
            return out
    sa = build_suffix_array_sharded(text, mesh, info=info, msd=msd)
    return sa, build_lcp_array_sharded(text, sa, mesh, info=info)


__all__ = [
    "Mesh",
    "build_sa_lcp_sharded",
    "make_mesh",
    "shard",
    "unshard",
    "build_suffix_array_sharded",
    "build_suffix_array_sharded_big",
    "suffix_array_kernel_sharded",
    "build_lcp_array_sharded",
    "is_valid_suffix_array_sharded",
    "sharded_msd_min",
    "wide_auto",
]
