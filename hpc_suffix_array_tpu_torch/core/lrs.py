"""Longest repeated substring extraction.

Counterpart of ``hpc_suffix_array_tpu/core/lrs.py``: argmax over the
LCP array with first-occurrence tie-breaking (the reference's strict
'>' scan), substring taken at ``sa[argmax]``. ``torch.argmax`` returns
the first maximal index, so the extracted string is identical. Returns
None when there is no repeat (max LCP == 0).
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_array
from hpc_suffix_array_tpu_torch.device import resolve_device


def lrs_locate(lcp: torch.Tensor, sa: torch.Tensor) -> tuple[int, int]:
    """(max_lcp, start): length and text offset of the first-maximal LRS."""
    j = torch.argmax(lcp)
    return int(lcp[j]), int(sa[j])


def find_longest_repeated_substring(text, sa, lcp, *, device):
    """The longest repeated substring as bytes, or None if no repeat."""
    dev = resolve_device(device)
    if not isinstance(text, torch.Tensor):
        text = as_byte_array(text)      # str: slice bytes, not characters
    if text.shape[0] == 0:
        return None
    length, start = lrs_locate(
        torch.as_tensor(lcp).to(device=dev, dtype=torch.int32),
        torch.as_tensor(sa).to(device=dev, dtype=torch.int32))
    if length == 0:
        return None
    # A tensor text is sliced where it lies: only the match is copied.
    return as_byte_array(text[start:start + length]).tobytes()
