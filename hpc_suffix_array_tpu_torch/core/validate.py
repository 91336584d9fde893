"""Suffix-array self-validation, O(n) and fully vectorized.

Counterpart of ``hpc_suffix_array_tpu/core/validate.py``:

  sa is the suffix array of text iff
    (1) sa is a permutation of [0, n);
    (2) for consecutive entries a = sa[j-1], b = sa[j]:
        text[a] < text[b],  or
        text[a] == text[b] and next_rank(a) < next_rank(b),
  where next_rank(s) = isa[s+1] and the empty suffix ranks -1.

Up to ``SA_VALIDATE_FUSED_MAX`` positions one fused check runs
(``validate_kernel``); above it the check runs in chunks of at most
``CHUNK`` rows, as the JAX package's does: the inverse permutation is
one int32[n] tensor scattered in place chunk by chunk, and the order
check reads one chunk of SA rows at a time. The fused form's int64
indices and gathers for all n rows at once cost about 37 B a position
beyond text, sa and lcp; the chunked form adds isa (4 B a position) and
one chunk's temporaries.
"""

from __future__ import annotations

import os

import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_tensor
from hpc_suffix_array_tpu_torch.device import resolve_device

# Default of ``SA_VALIDATE_FUSED_MAX`` and the chunk width above it,
# measured on an H100 80GB HBM3 (PERF.md, ``msd_probe.py validate``).
# Up to 2^28 the fused form was the fastest by 2-5% and its peak stays
# below the direct build's own; at 2^30 it added 37.00 GiB, where 2^26
# chunks added 5.69 GiB within 2% of its time (2^24 chunks: 8% slower).
# The JAX package's 2^26 and 2^24 were set for a 16 GB chip.
FUSED_MAX = 1 << 28
CHUNK = 1 << 26


def fused_max() -> int:
    """Largest n checked by the fused form (``SA_VALIDATE_FUSED_MAX``),
    read at call time."""
    return int(os.environ.get("SA_VALIDATE_FUSED_MAX", FUSED_MAX))


def validate_kernel(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: permutation + adjacent-order check, on sa's device.

    Memory per position: int64 indices (8 B) for sa and the gathers, on
    top of text and sa."""
    n = text.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=sa.device)
    in_range = ((sa >= 0) & (sa < n)).all()
    sa_c = sa.clamp(0, n - 1).long()
    # n writes into n slots with no hole <=> bijection (pigeonhole). With
    # duplicate indices, index_put_ on CUDA leaves which write wins
    # undefined, but n writes into fewer than n distinct slots leave a
    # -1 hole whichever wins, so the verdict is still exact.
    isa = torch.full((n,), -1, dtype=torch.int32, device=sa.device)
    isa[sa_c] = iota
    is_perm = in_range & (isa >= 0).all()

    def next_rank(s):
        return torch.where(s + 1 < n, isa[(s + 1).clamp_(max=n - 1)],
                           torch.tensor(-1, dtype=torch.int32,
                                        device=sa.device))

    a, b = sa_c[:-1], sa_c[1:]
    ca, cb = text[a], text[b]
    ordered = ((ca < cb) | ((ca == cb) & (next_rank(a) < next_rank(b)))).all()
    return is_perm & ordered


def _isa_scatter_chunk(isa: torch.Tensor, sa: torch.Tensor, start: int,
                       width: int) -> torch.Tensor:
    """Scatter rows [start, start + width) of the inverse permutation
    into ``isa`` in place (the last chunk is shorter); returns the 0-d
    flag that every entry of the chunk lies in [0, n)."""
    n = sa.shape[0]
    seg = sa[start:start + width]
    in_range = ((seg >= 0) & (seg < n)).all()
    isa[seg.clamp(0, n - 1).long()] = torch.arange(
        start, start + seg.shape[0], dtype=torch.int32, device=sa.device)
    return in_range


def _order_chunk(text: torch.Tensor, isa: torch.Tensor, sa: torch.Tensor,
                 start: int, width: int) -> torch.Tensor:
    """0-d bool: the order check for SA rows (j-1, j), j in
    [start + 1, start + width], cut at n - 1."""
    n = sa.shape[0]
    seg = sa[start:start + width + 1].clamp(0, n - 1).long()
    a, b = seg[:-1], seg[1:]
    ca, cb = text[a], text[b]
    minus1 = torch.tensor(-1, dtype=torch.int32, device=sa.device)
    na = torch.where(a + 1 < n, isa[(a + 1).clamp_(max=n - 1)], minus1)
    nb = torch.where(b + 1 < n, isa[(b + 1).clamp_(max=n - 1)], minus1)
    return ((ca < cb) | ((ca == cb) & (na < nb))).all()


def validate_chunked(text: torch.Tensor, sa: torch.Tensor,
                     width: int) -> bool:
    """The check in chunks of ``width`` rows: int64 and every other
    temporary only inside a chunk. The permutation flags (entries in
    range, no hole left in isa) are enqueued and read once, then the
    order flags."""
    n = sa.shape[0]
    isa = torch.full((n,), -1, dtype=torch.int32, device=sa.device)
    perm = [_isa_scatter_chunk(isa, sa, start, width)
            for start in range(0, n, width)]
    perm += [(isa[start:start + width] >= 0).all()
             for start in range(0, n, width)]
    if not bool(torch.stack(perm).all()):
        return False
    flags = [_order_chunk(text, isa, sa, start, width)
             for start in range(0, n - 1, width)]
    return bool(torch.stack(flags).all()) if flags else True


def is_valid_suffix_array(text, sa, *, device) -> bool:
    """True iff ``sa`` is exactly the suffix array of ``text``."""
    dev = resolve_device(device)
    t = as_byte_tensor(text, dev)
    n = t.shape[0]
    if n == 0:
        return True
    sa = torch.as_tensor(sa).to(device=dev, dtype=torch.int32)
    if sa.dim() != 1 or sa.shape[0] != n:
        return False
    limit = fused_max()
    if n <= limit:
        return bool(validate_kernel(t, sa))
    return validate_chunked(t, sa, min(CHUNK, limit))
