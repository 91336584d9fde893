"""Per-round primitives of the doubling builder: shift, pair sort, re-rank."""

from hpc_suffix_array_tpu_torch.ops.scan import dense_ranks, route_to_positions
from hpc_suffix_array_tpu_torch.ops.shift import shifted_ranks
from hpc_suffix_array_tpu_torch.ops.sort import composite_key, sort_by_rank_pairs

__all__ = ["composite_key", "dense_ranks", "route_to_positions",
           "shifted_ranks", "sort_by_rank_pairs"]
