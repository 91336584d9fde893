"""The refinement's word round around its sort: the hand-written kernels
and their plain versions.

A word round (``core/refine.py::refine_round``) gathers the next two key
words of each row from the pair table (``round_gather``), sorts the rows
by (segment, word 0, word 1) with the onesweep radix sort, and splits the
sorted rows into segments where the words differ (``round_split``). On
CUDA tensors the two functions launch ``csrc/refine_round.cu`` (one
launch for the gather, three for the split) and count one call each in
"launches: refine_gather" / "launches: refine_split"; on CPU tensors they
run ``round_gather_reference`` / ``round_split_reference``, the port's
first PyTorch body of the round, which are also the kernels' oracle.
There is no fallback between the two: a CUDA call launches the kernel or
raises. Either adds the bytes the call must move to "refine_round_bytes"
in the recorder of ``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.kernels import _build
from hpc_suffix_array_tpu_torch.kernels.post_sort import _high_bit
from hpc_suffix_array_tpu_torch.utils.profiling import count


def segment_ids(head: torch.Tensor) -> torch.Tensor:
    """int32 ordinal of each row's segment (head[0] must be set).

    The JAX package labels a segment by its head's position (a running
    max); any label that is equal inside a segment and grows from one
    segment to the next sorts and splits the same. The ordinal is one
    ``cumsum``: on an H100 ``torch.cummax`` of the head positions took
    71% of the refinement's device time (PERF.md)."""
    return torch.cumsum(head, 0, dtype=torch.int32) - 1


def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x moved down one row, -1 in row 0."""
    return torch.cat([x.new_full((1,), -1), x[:-1]])


def round_gather_bytes(rows: int) -> int:
    """Bytes a gather of ``rows`` rows must move: the position read (4 B),
    one pair-table row read (8 B) and the two words written (8 B)."""
    return 20 * rows


def round_split_bytes(rows: int) -> int:
    """Bytes a split of ``rows`` rows must move: the segment ordinal and
    the two words read (12 B), the patch read and written (8 B) and the
    new ordinal written (4 B)."""
    return 24 * rows


def _check_int32(cols, what: str) -> int:
    m = cols[0].shape[0]
    if m < 1:
        raise ValueError(f"{what} needs at least one row")
    for col in cols:
        if (col.dtype != torch.int32 or col.dim() != 1 or col.shape[0] != m
                or col.device != cols[0].device):
            raise TypeError(f"{what}: columns must be int32[{m}] on one "
                            f"device, got {col.dtype} {tuple(col.shape)} on "
                            f"{col.device}")
    return m


def _check_gather(idx, pk2, d: int) -> int:
    m = _check_int32([idx], "round_gather")
    if (pk2.dtype != torch.int32 or pk2.dim() != 2 or pk2.shape[1] != 2
            or pk2.shape[0] < 1 or pk2.device != idx.device):
        raise TypeError(f"pk2 must be int32[n + 1, 2] on {idx.device}, got "
                        f"{pk2.dtype} {tuple(pk2.shape)} on {pk2.device}")
    if d < 0:
        raise ValueError(f"depth d must be >= 0, got {d}")
    return m


def _check_split(s_seg, s0, s1, patch, d: int, spw: int, bits: int) -> int:
    m = _check_int32([s_seg, s0, s1, patch], "round_split")
    if spw < 1 or bits < 1 or bits * spw > 30:
        raise ValueError(f"packing bits={bits}, spw={spw}: need bits * spw "
                         "<= 30")
    if d < 0 or d + 2 * spw >= 1 << 31:
        raise ValueError(f"depth d={d} out of the int32 patch range")
    return m


def round_gather_reference(idx: torch.Tensor, pk2: torch.Tensor, d: int):
    """Plain PyTorch version of ``round_gather`` (the same arguments and
    results)."""
    _check_gather(idx, pk2, d)
    n = pk2.shape[0] - 1
    g = pk2[(idx + d).clamp_(max=n).long()]
    return g[:, 0].contiguous(), g[:, 1].contiguous()


def round_split_reference(s_seg, s0, s1, patch, d: int, spw: int,
                          bits: int):
    """Plain PyTorch version of ``round_split`` (the same arguments and
    results, written in place as there)."""
    _check_split(s_seg, s0, s1, patch, d, spw, bits)
    parent_head = s_seg != _shift1(s_seg)
    x0, x1 = s0 ^ _shift1(s0), s1 ^ _shift1(s1)
    in_w0 = x0 != 0
    wdiff = in_w0 | (x1 != 0)
    new_head = parent_head | wdiff
    # Symbols pack first-highest: the xor's highest set bit names the
    # first differing symbol (post_sort's LCP arithmetic), in word 0
    # where it differs, else in word 1.
    hb = _high_bit(torch.where(in_w0, x0, x1))
    last = 2 * spw - 1 - spw * in_w0.to(torch.int32)
    sym = last - torch.div(hb, bits, rounding_mode="floor")
    patch.copy_(torch.where(wdiff & ~parent_head, d + sym, patch))
    tied = (~new_head).sum()
    s_seg.copy_(segment_ids(new_head))
    return s_seg, patch, tied


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _cuda_only(cols, what: str) -> None:
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel: unsupported device {dev}")
    for t in cols:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: every tensor must be "
                             f"contiguous on {dev}")


def _launch_gather(idx, pk2, d: int):
    _cuda_only([idx, pk2], "round_gather")
    if pk2.data_ptr() % 8:
        raise ValueError("round_gather kernel: pk2 rows must be 8-byte "
                         "aligned")
    m, dev = idx.shape[0], idx.device
    w0 = torch.empty(m, dtype=torch.int32, device=dev)
    w1 = torch.empty(m, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.sa_round_gather(idx.data_ptr(), pk2.data_ptr(),
                                  w0.data_ptr(), w1.data_ptr(), m, d,
                                  pk2.shape[0] - 1, _stream(dev))
    _build.check(err, "sa_round_gather")
    return w0, w1


def _launch_split(s_seg, s0, s1, patch, d: int, spw: int, bits: int):
    _cuda_only([s_seg, s0, s1, patch], "round_split")
    m, dev = s_seg.shape[0], s_seg.device
    lib = _build.load()
    tile = lib.sa_round_tile_rows()
    tiles = (m + 3) // tile + 1                   # any lead of 0-3 rows
    heads = torch.empty(tiles * tile // 32, dtype=torch.int32, device=dev)
    counts = torch.empty(tiles, dtype=torch.int32, device=dev)
    tied = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.sa_round_split(s_seg.data_ptr(), s0.data_ptr(),
                                 s1.data_ptr(), patch.data_ptr(),
                                 heads.data_ptr(), counts.data_ptr(), tiles,
                                 tied.data_ptr(), m, d, spw, bits,
                                 _stream(dev))
    _build.check(err, "sa_round_split")
    return s_seg, patch, tied


def round_gather(idx: torch.Tensor, pk2: torch.Tensor, d: int):
    """The words of each row's window at depth ``d``: (w0, w1), each
    int32[rows], with ``(w0[j], w1[j]) = pk2[min(idx[j] + d, n)]``, where
    ``pk2`` is the int32[n + 1, 2] pair table (``core/refine.py::
    pair_table``; row n is the all-pad pair) and ``idx`` the rows' text
    positions.

    On CUDA tensors this launches the kernel on the current stream and
    adds one to "launches: refine_gather"; on CPU tensors it runs
    ``round_gather_reference``. Either adds ``round_gather_bytes`` to
    "refine_round_bytes"."""
    m = _check_gather(idx, pk2, d)
    if idx.device.type == "cpu":
        out = round_gather_reference(idx, pk2, d)
    else:
        out = _launch_gather(idx, pk2, d)
        count("launches: refine_gather")
    count("refine_round_bytes", round_gather_bytes(m))
    return out


def round_split(s_seg: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
                patch: torch.Tensor, d: int, spw: int, bits: int):
    """Splits rows sorted by (segment ordinal, word 0, word 1) where the
    words differ.

    Row j compares with row j - 1 (row 0 with a -1 sentinel in every
    column): it heads a new segment where its ordinal or a word differs.
    Where only the words differ (a new boundary inside an old segment),
    ``patch[j]`` becomes ``d`` plus the first differing symbol (words of
    ``spw`` symbols of ``bits`` bits, first symbol highest: the highest
    set bit of the first nonzero xor). Writes the new segment ordinals
    over ``s_seg`` and the patch in place; returns (s_seg, patch, tied),
    ``tied`` an int64 device scalar: the rows that head no segment.

    On CUDA tensors this launches the kernel on the current stream (three
    launches) and adds one to "launches: refine_split"; on CPU tensors it
    runs ``round_split_reference``. Either adds ``round_split_bytes`` to
    "refine_round_bytes"."""
    m = _check_split(s_seg, s0, s1, patch, d, spw, bits)
    if s_seg.device.type == "cpu":
        out = round_split_reference(s_seg, s0, s1, patch, d, spw, bits)
    else:
        out = _launch_split(s_seg, s0, s1, patch, d, spw, bits)
        count("launches: refine_split")
    count("refine_round_bytes", round_split_bytes(m))
    return out
