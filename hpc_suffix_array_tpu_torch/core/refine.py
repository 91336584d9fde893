"""Device tie refinement: resolve every window-tied group of a direct build.

Counterpart of ``hpc_suffix_array_tpu/core/refine.py``. The direct
builder (``core/bigsort.py``) orders each suffix by its first
``nw*spw`` symbols; natural text (words, source, logs) leaves most
positions tied at that depth, far past the host residue's cap. This
module orders them on the device, as the JAX package does:

  1. *Extract* every tied member (final SA slot, text index, group head)
     with one ``torch.nonzero``, and cut the members into pieces of about
     ``SA_REFINE_PIECE`` rows at group heads, so each group lies in
     exactly one piece.
  2. *Refine* each piece by rounds: gather the next ``2*spw`` symbols of
     each row as a pair of packed words (``pk2``, one K1 launch), sort
     the rows by (segment, word 0, word 1) with the onesweep radix sort,
     split segments where the words differ, and record the exact LCP of
     each new boundary from the highest set bit of the words' xor.
     Segment ids are ordinals, by ``torch.cumsum`` of the head flags.
     When at most a quarter of the rows is still tied,
     the resolved rows are committed and the rounds go on over the tied
     ones only.
  3. *Close* the small remainder on the host with
     ``core/bigsort.py::_resolve_residue_host``: each piece hands over
     its still-tied segments (the heads of ``tied_rows``) and the depth
     ``d`` its rounds proved them equal through, and the closer extends
     from there by doubling byte windows until every segment is split.
     It is exact at any depth, so correctness never depends on the
     round budget; the boundaries between segments keep the LCPs their
     rounds recorded.

Refinement packs with reserved-0 codes (past the end is 0, below every
real code) even when the main build used minpad: a pair whose shorter
suffix ends inside a window then separates at exactly that length, so
the rounds terminate and the recorded LCP is exact. Minpad builds
re-verify from depth 0; reserved-0 builds start at the verified
``nw*spw`` symbols.

Not ported from the JAX package: the bit-packed tie masks, the batched
window-gather round trips and the host cut scan of the piece partition,
the ``_prefix_max`` ladder (segment ordinals instead), the chunked
table builds, the 1-D table with its ``SA_REFINE_PK2`` switch, the
fused/staged extraction split and the ``SLOT_PAD`` pad rows. They were
workarounds for XLA and TPU v5e memory; a piece here has exactly its
member count of rows, so there are no pad segments to wrap int32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.bigsort import (
    _apply_residue, _high_bit, _sync, key_depth)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words
from hpc_suffix_array_tpu_torch.kernels.radix import radix_sort_words
from hpc_suffix_array_tpu_torch.utils.profiling import record, span


class RefineOverflow(NotImplementedError):
    """Refinement cannot finish within its caps: a piece holds more than
    ``SA_REFINE_GROUP_MAX`` members (one huge tie group), or more than
    ``4 * SA_REFINE_HOST_PIECE`` members are still tied after
    ``SA_REFINE_ROUNDS`` rounds. A ``NotImplementedError``, so the
    routers catch it and fall back (doubling, or host SA-IS past its
    reach)."""


def refine_knobs() -> dict:
    """The JAX package's knobs, read from its environment names. The
    piece target and the group cap were 2^22 and 2^26 on a TPU v5e; on
    an H100 80GB one piece of up to 2^28 members (every member of a
    direct build at the default ``SA_DIRECT_MAX``) refined the 2^28
    words text in 454-470 ms against 517-520 ms at 2^26 and about
    950 ms at 2^22, with a 18.86 GiB peak (PERF.md). The round cap and
    the host budget keep the JAX package's values."""
    env = os.environ.get
    return {"piece": int(env("SA_REFINE_PIECE", 1 << 28)),
            "group_max": int(env("SA_REFINE_GROUP_MAX", 1 << 28)),
            "rounds": int(env("SA_REFINE_ROUNDS", 64)),
            "host_piece": int(env("SA_REFINE_HOST_PIECE", 1 << 13))}


def refine_packing(sigma: int) -> tuple[int, int]:
    """(bits, spw) of the reserved-0 refinement words."""
    bits = max(1, int(sigma).bit_length())
    return bits, 30 // bits


def pair_table(text: torch.Tensor, remap: np.ndarray) -> torch.Tensor:
    """pk2 int32[n + 1, 2]: row i holds the reserved-0 words at i and at
    i + spw (one two-word K1 launch into pk2's columns); row n is the
    all-pad word pair, which the rounds read for every window that
    starts at n."""
    n = text.shape[0]
    bits, spw = refine_packing(int(remap.max()))
    table = torch.as_tensor(remap.astype(np.int32)).to(text.device)
    pk2 = torch.empty((n + 1, 2), dtype=torch.int32, device=text.device)
    pk2[n] = 0
    pack_words(text, table, bits, spw, n, 2, out=[pk2[:n, 0], pk2[:n, 1]])
    return pk2


def piece_bounds(head: torch.Tensor, target: int) -> list[int]:
    """Row bounds [0, ..., M] of pieces of at most ``target`` members
    each where the groups allow, every piece starting at a group head
    (``head[0]`` is one). Greedy: a piece from row x ends at the last
    head at or before x + target, or, where one group is longer than
    ``target``, at the first head after x. (Ending pieces at the first
    head at or after each multiple of ``target`` let them outgrow it by
    a group's tail, past ``SA_REFINE_GROUP_MAX`` = the target on 2^30
    words.) One host read per piece."""
    m = head.shape[0]
    bounds = [0]
    if m <= target:
        return bounds + [m]
    heads = torch.nonzero(head).view(-1)
    ends = torch.cat([heads, heads.new_full((1,), m)])
    while bounds[-1] + target < m:
        x = bounds[-1]
        at = torch.searchsorted(heads, torch.tensor([x + target, x],
                                                    device=heads.device),
                                right=True)
        last, after = ends[at[0] - 1], ends[at[1]]
        bounds.append(int(torch.where(last > x, last, after)))
    if bounds[-1] != m:
        bounds.append(m)
    return bounds


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


def refine_round(seg, idx, patch, pk2, d: int, spw: int, bits: int):
    """One deepening round over a piece (rows in position order).

    Sorts the rows by (segment, word 0, word 1) of their windows at
    depth ``d``, with the onesweep radix sort and the text index as
    payload; splits segments where the windows differ; records
    ``d + first differing symbol`` at each new boundary inside an old
    segment into the positional ``patch``; returns (seg, idx, patch,
    tied pairs). Rows move only inside their segment's position range,
    so a boundary formed at position p stays at p. ``seg`` and ``idx``
    are consumed (sorted in place)."""
    n = pk2.shape[0] - 1
    rows = seg.shape[0]
    g = pk2[(idx + d).clamp_(max=n).long()]
    w0, w1 = g[:, 0].contiguous(), g[:, 1].contiguous()
    del g
    seg_bits = max(1, (rows - 1).bit_length())
    (s_seg, s0, s1), s_idx = radix_sort_words(
        [seg, w0, w1], idx, [seg_bits, bits * spw, bits * spw])
    parent_head = s_seg != _shift1(s_seg)
    x0, x1 = s0 ^ _shift1(s0), s1 ^ _shift1(s1)
    del s_seg, s0, s1
    in_w0 = x0 != 0
    wdiff = in_w0 | (x1 != 0)
    new_head = parent_head | wdiff
    # Symbols pack first-highest: the xor's highest set bit names the
    # first differing symbol (post_sort's LCP arithmetic), in word 0
    # where it differs, else in word 1.
    hb = _high_bit(torch.where(in_w0, x0, x1))
    last = 2 * spw - 1 - spw * in_w0.to(torch.int32)
    sym = last - torch.div(hb, bits, rounding_mode="floor")
    patch = torch.where(wdiff & ~parent_head, d + sym, patch)
    tied = int((~new_head).sum())           # the round's one host read
    return segment_ids(new_head), s_idx, patch, tied


def tied_rows(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows int64[k], head bool[k]) of the segments that still hold two
    or more rows, ascending; ``head`` marks each segment's first row."""
    starts = seg != _shift1(seg)
    nxt = torch.cat([seg[1:], seg.new_full((1,), -1)])
    member = ~starts | (seg == nxt)
    rows = torch.nonzero(member).view(-1)
    return rows, starts[rows]


def _commit(sa, lcp, slot, idx, patch) -> None:
    """sa[slot] = idx and lcp[slot] = patch where a boundary was
    recorded. The slots of a piece are distinct, so no index is written
    twice in one scatter."""
    sa.index_copy_(0, slot, idx)
    if lcp is not None:
        lcp.index_copy_(0, slot, torch.where(patch >= 0, patch, lcp[slot]))


def refine_ties(sa: torch.Tensor, tie: torch.Tensor,
                lcp: torch.Tensor | None, text: torch.Tensor, *,
                remap: np.ndarray, spw_main: int, nw: int, minpad: bool,
                host_text: np.ndarray, want_lcp: bool,
                meta: dict | None = None):
    """Resolve every window-tied group of a direct build exactly.

    Args:
      sa:   int32[n], the build's order; tied groups in any order.
            Refined in place.
      tie:  bool[n]; tie[j]: slot j's key words equal slot j-1's.
      lcp:  int32[n] or None; tied rows hold lower bounds. Patched in
            place where ``want_lcp``.
      text: uint8[n] on the device.
      remap: the dense alphabet table (codes 1..sigma), the reserved-0
            refinement table.
      spw_main, nw, minpad: the main build's packing; the verified depth
            is ``nw * spw_main`` symbols, or 0 under minpad.
      host_text: np.uint8[n] for the exact host closer.
      meta: optional dict that receives ``refine_members``,
            ``refine_pieces``, ``refine_rounds`` (most in one piece),
            ``refine_host_members`` and ``refine_phase_s`` (host seconds
            of the spans of ``REFINE_PHASES``).

    Returns (sa, lcp). Raises RefineOverflow when a cap is exceeded.
    """
    meta = meta if meta is not None else {}
    with record("refine", own=True) as rec:
        mark = rec.mark()
        out = _refine(sa, tie, lcp, text, remap, spw_main, nw, minpad,
                      host_text, want_lcp, meta)
        totals = rec.totals(mark)
    if meta["refine_members"]:
        meta["refine_phase_s"] = {
            k: round(totals.get(name, {}).get("ms", 0.0) / 1e3, 3)
            for k, name in REFINE_PHASES.items()}
    return out


# ``refine_phase_s``' keys and the spans they read.
REFINE_PHASES = {"extract": "refine: extract", "pk": "refine: pair_table",
                 "rounds": "refine: rounds", "host_fetch": "refine: fetch"}


def _refine(sa, tie, lcp, text, remap, spw_main: int, nw: int,
            minpad: bool, host_text, want_lcp: bool, meta: dict):
    knobs = refine_knobs()
    n, dev = sa.shape[0], sa.device
    bits, spw = refine_packing(int(remap.max()))
    d0 = key_depth(nw, spw_main, minpad)
    if not want_lcp:
        lcp = None

    with span("refine: extract"):
        # A flag marks the later element of a tied pair; a group's head
        # joins through its successor's flag (_extract_ties' rule).
        member = tie.clone()
        member[:-1] |= tie[1:]
        slots = torch.nonzero(member).view(-1)
        del member
        meta.update(refine_members=slots.shape[0], refine_pieces=0,
                    refine_rounds=0, refine_host_members=0)
        if slots.shape[0] == 0:
            return sa, lcp
        heads = ~tie[slots]
        bounds = piece_bounds(heads, knobs["piece"])
        sizes = np.diff(bounds)
        if sizes.max() > knobs["group_max"]:
            raise RefineOverflow(
                f"a refinement piece holds {int(sizes.max())} tied members "
                f"(> SA_REFINE_GROUP_MAX={knobs['group_max']}): one tie "
                "group exceeds the device sort budget")
        meta["refine_pieces"] = len(sizes)
        _sync(dev)

    with span("refine: pair_table"):
        pk2 = pair_table(text, remap)
        _sync(dev)

    host_patches = []
    rounds_max = 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        with span("refine: rounds"):
            slot = slots[a:b]
            idx = sa[slot]
            seg = segment_ids(heads[a:b])
            patch = torch.full_like(idx, -1)
            d, tied, rounds = d0, b - a, 0
            while (tied and rounds < knobs["rounds"]
                   and tied > knobs["host_piece"]):
                if tied <= slot.shape[0] // 4 and slot.shape[0] > 1 << 12:
                    # Geometric compaction: commit the resolved rows and
                    # keep deepening only the still-tied segments.
                    _commit(sa, lcp, slot, idx, patch)
                    keep, head = tied_rows(seg)
                    slot, idx = slot[keep], idx[keep]
                    seg = segment_ids(head)
                    patch = torch.full_like(idx, -1)
                seg, idx, patch, tied = refine_round(seg, idx, patch, pk2,
                                                     d, spw, bits)
                d += 2 * spw
                rounds += 1
            rounds_max = max(rounds_max, rounds)
        with span("refine: fetch"):
            if tied:
                keep, head = tied_rows(seg)
                if keep.shape[0] > 4 * knobs["host_piece"]:
                    raise RefineOverflow(
                        f"{keep.shape[0]} members still tied after {rounds} "
                        "refinement rounds (> 4*SA_REFINE_HOST_PIECE)")
                # The segments, each tied through the d symbols the
                # rounds proved, go to the host closer as they are.
                host_patches.append((slot[keep].cpu().numpy(),
                                     idx[keep].cpu().numpy(),
                                     head.cpu().numpy(), d))
            _commit(sa, lcp, slot, idx, patch)
    del pk2, slots, heads

    with span("refine: fetch"):
        sa, lcp, n_host = _apply_residue(sa, lcp, host_text, host_patches,
                                         n, want_lcp)
        _sync(dev)
    meta["refine_rounds"] = rounds_max
    meta["refine_host_members"] = n_host
    return sa, lcp
