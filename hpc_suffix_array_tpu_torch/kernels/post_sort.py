"""The post-sort pass: the hand-written kernel and its plain version.

After a carried-keys sort (``core/bigsort.py``: the whole text in the
direct build, each live bucket in the MSD build) one pass over the
sorted key words and positions gives the tie flags, the chain
statistics and, with ``want_lcp``, the LCP of adjacent keys (see
``post_sort``). ``post_sort`` launches ``csrc/post_sort.cu`` for CUDA
tensors (two launches: the pass and the fold of its per-block partials)
and runs ``post_sort_reference``, the port's first PyTorch body, for CPU
tensors. There is no fallback between the two: a CUDA call launches the
kernel or raises. It counts its launches ("launches: post_sort", on
CUDA) and, on either device, the bytes the call must move
("post_sort_bytes") in the recorder of ``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.kernels import _build
from hpc_suffix_array_tpu_torch.utils.profiling import count


def _high_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each nonzero int32 (31 for a
    negative value), by a 5-step integer binary search. Exact for every
    int32; float log2 would round 2^k - 1 up."""
    pos = torch.zeros_like(x)
    v = x & 0x7FFFFFFF
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        pos += big.to(torch.int32) * s
    return torch.where(x < 0, 31, pos)


def post_sort_bytes(m: int, n_words: int, want_lcp: bool) -> int:
    """Bytes a pass over ``m`` rows must move: the key words and the
    positions read once (4 B each a row), the tie flag (1 B) and the LCP
    (4 B, with ``want_lcp``) written once."""
    return m * (4 * (n_words + 1) + 1 + 4 * bool(want_lcp))


def _check_args(words, s_idx, prev, tie_out, lcp_out) -> int:
    m = s_idx.shape[0]
    if m < 1:
        raise ValueError("post_sort needs at least one row")
    for col in (*words, s_idx):
        if col.dtype != torch.int32 or col.dim() != 1 or col.shape[0] != m:
            raise TypeError(f"key words and positions must be int32[{m}], "
                            f"got {col.dtype} {tuple(col.shape)}")
    if prev is not None and len(prev) != len(words):
        raise ValueError(f"prev has {len(prev)} words, need {len(words)}")
    if tie_out is not None and (tie_out.dtype != torch.bool
                                or tuple(tie_out.shape) != (m,)):
        raise TypeError(f"tie_out must be bool[{m}]")
    if lcp_out is not None and (lcp_out.dtype != torch.int32
                                or tuple(lcp_out.shape) != (m,)):
        raise TypeError(f"lcp_out must be int32[{m}]")
    return m


def post_sort_reference(words, s_idx: torch.Tensor, n: int, spw: int,
                        bits: int, desc_idx: bool, want_lcp: bool,
                        prev=None, tie_out=None, lcp_out=None):
    """Plain PyTorch version of ``post_sort`` (the same arguments and
    results), written into ``tie_out`` / ``lcp_out`` where given."""
    _check_args(words, s_idx, prev, tie_out, lcp_out)
    dev = s_idx.device
    big = 1 << 30
    m = s_idx.shape[0]
    tie = torch.zeros(m, dtype=torch.bool, device=dev)
    if m > 1:
        eq = words[0][1:] == words[0][:-1]
        for w in words[1:]:
            eq &= w[1:] == w[:-1]
        tie[1:] = eq
    prev_idx = torch.cat([s_idx[:1], s_idx[:-1]])
    delta = (prev_idx - s_idx) if desc_idx else (s_idx - prev_idx)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dmax = torch.where(tie, delta, zero).max()
    dmin = torch.where(tie, delta, torch.full_like(zero, big)).min()
    any_tie = tie.any()
    delta_ok = ~any_tie | ((dmin == dmax) & (dmax >= 1))
    stats = torch.stack([tie.sum(), dmax.long(), delta_ok.long()])
    if tie_out is not None:
        tie = tie_out.copy_(tie)
    if not want_lcp:
        return tie, stats, None
    nw = len(words)
    lcp = torch.full((m,), nw * spw, dtype=torch.int32, device=dev)
    # Word by word from the last: the first differing word wins.
    for w in reversed(range(nw)):
        head = (torch.full((1,), -1, dtype=torch.int32, device=dev)
                if prev is None else prev[w])
        x = torch.cat([head, words[w][:-1]]) ^ words[w]
        off = (w + 1) * spw - 1 - torch.div(_high_bit(x), bits,
                                            rounding_mode="floor")
        lcp = torch.where(x != 0, off.to(torch.int32), lcp)
    lcp.clamp_(min=0)
    if desc_idx:
        lcp = torch.where(tie, n - prev_idx, lcp)
    if lcp_out is not None:
        lcp = lcp_out.copy_(lcp)
    return tie, stats, lcp


def _launch(words, s_idx, n, spw, bits, desc_idx, want_lcp, prev, tie_out,
            lcp_out):
    """The kernel's two launches on the current stream (arguments
    checked)."""
    dev = s_idx.device
    if dev.type != "cuda":
        raise ValueError(f"post-sort kernel: unsupported device {dev}")
    if len(words) not in (2, 3):
        raise ValueError(f"the post-sort kernel takes 2 or 3 key words, "
                         f"got {len(words)}")
    m = s_idx.shape[0]
    tie = (torch.empty(m, dtype=torch.bool, device=dev) if tie_out is None
           else tie_out)
    lcp = None
    if want_lcp:
        lcp = (torch.empty(m, dtype=torch.int32, device=dev)
               if lcp_out is None else lcp_out)
    heads = [] if prev is None else list(prev)
    for t in (*words, s_idx, tie, *([lcp] if want_lcp else []), *heads):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"post-sort kernel: every tensor must be "
                             f"contiguous on {dev}")
    for h in heads:
        if h.dtype != torch.int32 or h.numel() != 1:
            raise TypeError("prev must hold one int32 a word")
    lib = _build.load()
    cap = lib.sa_post_sort_max_blocks()
    scratch = torch.empty(2 * cap, dtype=torch.int64, device=dev)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    ptrs = [w.data_ptr() for w in words] + [0] * (3 - len(words))
    heads = [h.data_ptr() for h in heads] + [0] * (3 - len(heads))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_post_sort(*ptrs, s_idx.data_ptr(), *heads,
                               tie.data_ptr(),
                               lcp.data_ptr() if want_lcp else 0,
                               scratch.data_ptr(), cap, stats.data_ptr(), m,
                               len(words), n, spw, bits, int(desc_idx),
                               stream)
    _build.check(err, "sa_post_sort")
    return tie, stats, lcp


def post_sort(words, s_idx: torch.Tensor, n: int, spw: int, bits: int,
              desc_idx: bool, want_lcp: bool, prev=None, tie_out=None,
              lcp_out=None):
    """The pass after the sort: the JAX package's ``_bucket_sort`` (one
    bucket of the MSD build, or the whole text as one bucket) and
    ``_direct_sort3`` in one, over 2 or 3 sorted key words of m rows (the
    plain version takes any number).

    Returns (tie bool[m], stats int64[3] = (tie count, dmax, delta_ok),
    lcp int32[m] or None). ``tie[j]``: row j's key words equal row
    j-1's; row 0 never ties (buckets differ in their keys). ``delta`` is
    the index step along ties (descending in chain mode); ``dmax`` is
    the largest tied step, 0 at least; ``delta_ok`` says every tie has
    the same step >= 1 (a step of 2^30 or more never does). The LCP of a
    non-tied pair is the first differing symbol of the keys, from the
    highest set bit of their xor. Row 0 compares with ``prev``, the key
    words of the row before it (the previous live bucket's last row:
    one-element tensors, one per word, read on the device), or with a
    -1 sentinel when None, whose bit 31 puts the symbol below 0, clamped
    to 0. ``n`` is the text length: in chain mode a tied pair's LCP is
    ``n - prev_idx`` (consecutive chain members). The flags and the LCP
    are written into ``tie_out`` (bool[m]) and ``lcp_out`` (int32[m])
    where given, e.g. a bucket's rows of the whole text's arrays.

    On CUDA tensors this launches the kernel on the current stream and
    adds one to "launches: post_sort"; on CPU tensors it runs
    ``post_sort_reference``. Either adds ``post_sort_bytes`` to
    "post_sort_bytes"."""
    m = _check_args(words, s_idx, prev, tie_out, lcp_out)
    if s_idx.device.type == "cpu":
        out = post_sort_reference(words, s_idx, n, spw, bits, desc_idx,
                                  want_lcp, prev, tie_out, lcp_out)
    else:
        out = _launch(words, s_idx, n, spw, bits, desc_idx, want_lcp, prev,
                      tie_out, lcp_out)
        count("launches: post_sort")
    count("post_sort_bytes", post_sort_bytes(m, len(words), want_lcp))
    return out
