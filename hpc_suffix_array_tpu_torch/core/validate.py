"""Suffix-array self-validation, O(n) and fully vectorized.

Counterpart of the fused check in ``hpc_suffix_array_tpu/core/validate.py``:

  sa is the suffix array of text iff
    (1) sa is a permutation of [0, n);
    (2) for consecutive entries a = sa[j-1], b = sa[j]:
        text[a] < text[b],  or
        text[a] == text[b] and next_rank(a) < next_rank(b),
  where next_rank(s) = isa[s+1] and the empty suffix ranks -1.

The JAX package's chunked form (for n above ``SA_VALIDATE_FUSED_MAX``)
existed for a 16 GB chip and is not ported; whether the card needs a
chunked form is measured, not assumed.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_tensor
from hpc_suffix_array_tpu_torch.device import resolve_device


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
    return bool(validate_kernel(t, sa))
