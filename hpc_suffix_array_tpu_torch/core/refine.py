"""Device tie refinement: resolve the window ties of a carried-keys build.

Counterpart of ``hpc_suffix_array_tpu/core/refine.py``. The direct
builder (``core/bigsort.py``) orders each suffix by its first
``nw*spw`` symbols; natural text (words, source, logs) and genomes
leave many positions tied at that depth, far past the host residue's
cap. This module orders them on the device:

  1. *Extract* every tied member (final SA slot and group head, by
     ``core/residue.py::extract_ties``), and cut the members into pieces
     of about ``SA_REFINE_PIECE`` rows at group heads, so each group lies
     in exactly one piece.
  2. *Word rounds*, only where they are needed: gather the next
     ``2*spw`` symbols of each row as a pair of packed words (``pk2``,
     one K1 launch), sort the rows by (segment, word 0, word 1) with the
     onesweep radix sort, split segments where the words differ, and
     record the exact LCP of each new boundary from the highest set bit
     of the words' xor. Segment ids are ordinals of the head flags. The
     gather and the split are hand-written kernels on the card
     (``kernels/refine_round.py``). A piece runs one round, then more
     while its tied rows exceed its share of one piece (a build of
     several pieces) or a round still cuts them fourfold (shallow ties,
     as in words, end so without the doubling's rank array); then its
     resolved rows are committed and its tied ones kept.
  3. *Doubling rounds* (Larsson and Sadakane), where more than
     ``SA_REFINE_HOST_PIECE`` rows are left, over the tied rows of all
     pieces at once, every segment proven equal through ``d`` symbols
     and every boundary's LCP below ``d``: one int32 rank a position
     (``rank_array``: an untied suffix's final slot, a tied one's
     segment head slot, -1 past the end), a sort of the rows by
     (segment, rank of suffix ``i + d``), a split where the ranks
     differ, and only then the new head slots scattered into the ranks,
     so the segments left are equal through ``2d``. A pair split with
     step ``d`` has LCP ``d + LCP(i + d, j + d)``; the suffixes ahead lie
     in different groups, so theirs is the least LCP between the two
     groups' head slots, with every boundary still inside a group read as
     unknown (``RangeMin``): no byte is compared. ``pk2`` is freed before
     the ranks are built.
  4. *Close* the small remainder, the still-tied segments from the
     depth ``d`` the rounds proved, with the exact host closer
     (``core/residue.py``), so correctness never depends on the round
     budget; the boundaries between segments keep their rounds' LCPs.

Refinement packs with reserved-0 codes (past the end is 0, below every
real code) even when the main build used minpad: a pair whose shorter
suffix ends inside a window then separates at exactly that length, so
the rounds terminate and the recorded LCP is exact. Every build starts
at the key window of ``nw*spw`` symbols: under minpad the few tied
suffixes shorter than it are first set apart at the head of their
groups (``_set_short_apart``), and the keys' LCPs are clamped to the
shorter suffix before the doubling reads them.

Not ported from the JAX package: the bit-packed tie masks, the batched
window-gather round trips and the host cut scan of the piece partition,
the ``_prefix_max`` ladder (segment ordinals instead), the chunked
table builds, the 1-D table with its ``SA_REFINE_PK2`` switch, the
fused/staged extraction split and the ``SLOT_PAD`` pad rows. They were
workarounds for XLA and TPU v5e memory; a piece here has exactly its
member count of rows, so there are no pad segments to wrap int32. The
JAX package deepens by word rounds alone (2*spw symbols a round).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.residue import (
    apply_residue, clamp_lcp, extract_ties, sync)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words
from hpc_suffix_array_tpu_torch.kernels.post_sort import _high_bit
from hpc_suffix_array_tpu_torch.kernels.radix import radix_sort_words
from hpc_suffix_array_tpu_torch.kernels.refine_round import (
    _shift1, round_gather, round_split, segment_ids)
from hpc_suffix_array_tpu_torch.utils.profiling import count, record, span

# An LCP not known yet: a boundary still inside a tied group, which the
# doubling's range minimum must not take for a bound.
UNKNOWN = (1 << 31) - 1
# RangeMin's block (entries read at each end of a range, on each of its
# two lower levels) and the ranges it answers a launch, which bounds its
# (ranges, block) temporaries to about 2.5 GiB.
RMQ_BLOCK = 32
RMQ_ROWS = 1 << 22
# Positions of the rank scatter at a time: bounds its int64 indices.
RANK_CHUNK = 1 << 26


class RefineOverflow(NotImplementedError):
    """Refinement cannot finish within its caps: a piece holds more than
    ``SA_REFINE_GROUP_MAX`` members (one huge tie group), or a piece's
    rows still tied when the rounds stop (``SA_REFINE_ROUNDS`` word
    rounds, or as many doubling rounds) exceed ``4 *
    SA_REFINE_HOST_PIECE``. A ``NotImplementedError``, so the routers
    catch it and fall back (doubling, or host SA-IS past its reach)."""


def refine_knobs() -> dict:
    """The JAX package's knobs, read from its environment names. The
    piece target and the group cap were 2^22 and 2^26 on a TPU v5e; on
    an H100 80GB one piece of up to 2^28 members (every member of a
    direct build at the default ``SA_DIRECT_MAX``) refined the 2^28
    words text in 454-470 ms against 517-520 ms at 2^26 and about
    950 ms at 2^22, with a 18.86 GiB peak (PERF.md). The round cap (of
    each piece's word rounds, and of the doubling rounds) and the host
    budget keep the JAX package's values."""
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


def refine_round(seg, idx, patch, pk2, d: int, spw: int, bits: int):
    """One deepening round over a piece (rows in position order).

    Gathers the words of each row's window at depth ``d``
    (``round_gather``), sorts the rows by (segment, word 0, word 1) with
    the onesweep radix sort and the text index as payload, and splits
    segments where the windows differ (``round_split``), which records
    ``d + first differing symbol`` at each new boundary inside an old
    segment into the positional ``patch``; returns (seg, idx, patch,
    tied pairs). Rows move only inside their segment's position range,
    so a boundary formed at position p stays at p. ``seg``, ``idx`` and
    ``patch`` are consumed (sorted or written in place)."""
    rows = seg.shape[0]
    w0, w1 = round_gather(idx, pk2, d)
    seg_bits = max(1, (rows - 1).bit_length())
    (s_seg, s0, s1), s_idx = radix_sort_words(
        [seg, w0, w1], idx, [seg_bits, bits * spw, bits * spw])
    s_seg, patch, tied = round_split(s_seg, s0, s1, patch, d, spw, bits)
    return s_seg, s_idx, patch, int(tied)     # the round's one host read


def tied_rows(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows int64[k], head bool[k]) of the segments that still hold two
    or more rows, ascending; ``head`` marks each segment's first row."""
    starts = seg != _shift1(seg)
    nxt = torch.cat([seg[1:], seg.new_full((1,), -1)])
    member = ~starts | (seg == nxt)
    rows = torch.nonzero(member).view(-1)
    return rows, starts[rows]


class TiedRows:
    """Rows of the refinement in slot order: ``slot`` (int32 SA slots),
    ``idx`` (the text indices in them), ``seg`` (segment ordinals),
    ``patch`` (the LCP a word round recorded for a row's slot, -1 where
    none; None in the doubling, which writes the LCP array itself), the
    depth ``d`` through which every segment is proven equal, ``tied``,
    an upper bound of the rows that are not a segment's first (exact
    after a round), and ``before``, ``tied`` before the latest round."""

    def __init__(self, slot, idx, head, d: int, patch: bool = True):
        self.slot, self.idx, self.seg = slot, idx, segment_ids(head)
        self.patch = torch.full_like(idx, -1) if patch else None
        self.d = d
        self.tied = self.before = slot.shape[0]

    def commit(self, sa, lcp) -> None:
        """sa[slot] = idx, and lcp[slot] = patch where a round recorded
        one. The slots are distinct, so no index is written twice in
        one scatter."""
        slot = self.slot.long()
        sa.index_copy_(0, slot, self.idx)
        if lcp is not None and self.patch is not None:
            lcp.index_copy_(0, slot, torch.where(self.patch >= 0,
                                                 self.patch, lcp[slot]))

    def compact(self) -> torch.Tensor:
        """Keeps the segments of two or more rows; returns their head
        flags."""
        keep, head = tied_rows(self.seg)
        self.slot, self.idx = self.slot[keep], self.idx[keep]
        self.seg = segment_ids(head)
        if self.patch is not None:
            self.patch = torch.full_like(self.idx, -1)
        return head


def _settle(sa, lcp, rows: TiedRows):
    """Commits ``rows`` and returns the still-tied ones as (slot, idx,
    head, d): the host closer's arguments."""
    rows.commit(sa, lcp)
    head = rows.compact()
    return rows.slot, rows.idx, head, rows.d


def _set_short_apart(sa, lcp, slots, heads, window: int) -> None:
    """Under minpad a group's equal key words prove its members equal
    through the key window, except a member shorter than the window: its
    keys pad with the minimum symbol past its end. Such a member is a
    proper prefix of every other member (and of each longer such one),
    so it leads the group, shortest first, with its length as the LCP to
    the next. Moves them there, each a segment of its own (``sa``,
    ``heads`` and ``lcp`` in place), so every segment left is equal
    through the window. ``slots`` (int64, ascending) and ``heads`` are
    the members; at most ``window - 1`` suffixes are that short."""
    n = sa.shape[0]
    short = torch.nonzero(sa >= n - window + 1).view(-1)
    at = torch.searchsorted(slots, short).clamp_(max=slots.shape[0] - 1)
    keep = slots[at] == short
    short, at = short[keep], at[keep]
    if not short.shape[0]:
        return
    seg = segment_ids(heads)
    first = torch.searchsorted(seg, seg[at]).tolist()
    end = torch.searchsorted(seg, seg[at], right=True).tolist()
    groups: dict[int, list] = {}
    for s, p, f, e in zip(short.tolist(), sa[short].tolist(), first, end):
        groups.setdefault(f, [e]).append((p, s))
    to, frm, put, val, new_heads, lcp_at, lcp_val = ([] for _ in range(7))
    for (f, (e, *members)), g0 in zip(groups.items(),
                                      slots[list(groups)].tolist()):
        members.sort(reverse=True)              # the shortest first
        target = range(g0, g0 + len(members))
        held = {s for _, s in members}
        to += [s for s in sorted(held) if s not in target]
        frm += [t for t in target if t not in held]
        put += list(target)
        val += [p for p, _ in members]
        # Each short member is a segment; the rest (if any) one more.
        new_heads += range(f, min(f + len(members) + 1, e))
        inner = min(len(members), e - f - 1)
        lcp_at += [g0 + j + 1 for j in range(inner)]
        lcp_val += [n - p for p, _ in members[:inner]]
    dev = sa.device

    def at_(xs):
        return torch.tensor(xs, dtype=torch.int64, device=dev)

    if frm:
        sa[at_(to)] = sa[at_(frm)]
    sa[at_(put)] = torch.tensor(val, dtype=sa.dtype, device=dev)
    heads[at_(new_heads)] = True
    if lcp is not None and lcp_at:
        lcp[at_(lcp_at)] = torch.tensor(lcp_val, dtype=lcp.dtype,
                                        device=dev)


def _compact_sparse(sa, lcp, rows: TiedRows) -> None:
    """Geometric compaction: where at most a quarter of over 2^12 rows
    is still tied, commit the resolved rows and keep deepening only the
    still-tied segments."""
    if rows.tied <= rows.slot.shape[0] // 4 and rows.slot.shape[0] > 1 << 12:
        rows.commit(sa, lcp)
        rows.compact()


def _word_rounds(sa, lcp, rows: TiedRows, pk2, spw: int, bits: int,
                 budget: int, more) -> int:
    """Word rounds (``refine_round``, ``2*spw`` symbols deeper each)
    while rows are tied and ``more(rows, rounds run)`` holds, at most
    ``budget``. Returns the rounds run."""
    r = 0
    while rows.tied and r < budget and more(rows, r):
        _compact_sparse(sa, lcp, rows)
        rows.before = rows.tied
        rows.seg, rows.idx, rows.patch, rows.tied = refine_round(
            rows.seg, rows.idx, rows.patch, pk2, rows.d, spw, bits)
        rows.d += 2 * spw
        r += 1
    return r


def rank_array(sa: torch.Tensor, slot: torch.Tensor, idx: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """int32[n + 1]: each suffix's slot in ``sa``, except that each tied
    row (``slot``/``idx``, segments started by ``head``) gets its
    segment's head slot; -1 at n, past the end, below every suffix."""
    n = sa.shape[0]
    rank = torch.empty(n + 1, dtype=torch.int32, device=sa.device)
    for s in range(0, n, RANK_CHUNK):
        e = min(s + RANK_CHUNK, n)
        rank[sa[s:e].long()] = torch.arange(s, e, dtype=torch.int32,
                                            device=sa.device)
    rank[n] = -1
    rank[idx.long()] = slot[head].to(torch.int32)[segment_ids(head).long()]
    return rank


def _block_min(v: torch.Tensor) -> torch.Tensor:
    """Minimum of each block of ``RMQ_BLOCK`` entries of ``v`` (the last
    block may be shorter)."""
    m = v.shape[0] // RMQ_BLOCK * RMQ_BLOCK
    out = v[:m].view(-1, RMQ_BLOCK).amin(1)
    if m < v.shape[0]:
        out = torch.cat([out, v[m:].amin().view(1)])
    return out


def _sparse_table(v: torch.Tensor) -> torch.Tensor:
    """int32[levels, len(v)]: row k holds the minimum of each run of
    2^k entries from each start (UNKNOWN where the run passes the
    end)."""
    m = v.shape[0]
    table = torch.full((max(1, m.bit_length()), m), UNKNOWN,
                       dtype=torch.int32, device=v.device)
    table[0] = v
    for k in range(1, table.shape[0]):
        h, w = 1 << (k - 1), m - (1 << k) + 1
        table[k, :w] = torch.minimum(table[k - 1, :w], table[k - 1, h:h + w])
    return table


def _ends_min(v: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Minimum of ``v`` over the first and the last ``RMQ_BLOCK``
    entries of each range [lo, hi] (int64), UNKNOWN where lo > hi."""
    ok = lo <= hi
    lo, hi = torch.where(ok, lo, 0), torch.where(ok, hi, 0)
    off = torch.arange(RMQ_BLOCK, device=lo.device)
    first = v[torch.minimum(lo[:, None] + off, hi[:, None])].amin(1)
    last = v[torch.maximum(hi[:, None] - off, lo[:, None])].amin(1)
    return torch.where(ok, torch.minimum(first, last), UNKNOWN)


def _table_min(table: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Minimum over [lo, hi] (int64) of the array under a
    ``_sparse_table``, from two of its entries; UNKNOWN where lo > hi."""
    ok = lo <= hi
    lo, hi = torch.where(ok, lo, 0), torch.where(ok, hi, 0)
    k = _high_bit((hi - lo + 1).to(torch.int32)).long()
    flat, m = table.view(-1), table.shape[1]
    got = torch.minimum(flat[k * m + lo], flat[k * m + hi + 1 - (1 << k)])
    return torch.where(ok, got, UNKNOWN)


class RangeMin:
    """Range minima of an int32 array whose entries only fall, for many
    ranges at once: the array, the minima of its blocks of
    ``RMQ_BLOCK``, and a sparse table over the minima of blocks of
    ``RMQ_BLOCK**2``. A range reads at most ``RMQ_BLOCK`` entries at
    each end on each of the two lower levels (the whole blocks between
    go to the level above) and two entries of the table."""

    def __init__(self, v: torch.Tensor):
        with span("refine: rmq", v.device):
            self.v = v
            self.blocks = _block_min(v)
            self.supers = _block_min(self.blocks)
            self.table = _sparse_table(self.supers)

    def lower(self, pos: torch.Tensor, val: torch.Tensor) -> None:
        """After ``v[pos] = val`` (int64 positions, values no higher than
        those they replace)."""
        with span("refine: rmq", self.v.device):
            pos = pos // RMQ_BLOCK
            self.blocks.scatter_reduce_(0, pos, val, "amin")
            self.supers.scatter_reduce_(0, pos // RMQ_BLOCK, val, "amin")
            self.table = _sparse_table(self.supers)

    def query(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """int32 minimum of ``v[lo..hi]`` for each pair (int64, lo <=
        hi), ``RMQ_ROWS`` ranges a launch. Counts them in
        ``rmq_ranges``."""
        count("rmq_ranges", lo.shape[0])
        with span("refine: rmq", self.v.device):
            out = torch.empty(lo.shape[0], dtype=torch.int32,
                              device=lo.device)
            for s in range(0, lo.shape[0], RMQ_ROWS):
                a, b = lo[s:s + RMQ_ROWS], hi[s:s + RMQ_ROWS]
                got = _ends_min(self.v, a, b)
                # Whole blocks strictly inside, then whole super-blocks.
                a, b = ((a + RMQ_BLOCK - 1) // RMQ_BLOCK,
                        (b + 1) // RMQ_BLOCK - 1)
                got = torch.minimum(got, _ends_min(self.blocks, a, b))
                a, b = ((a + RMQ_BLOCK - 1) // RMQ_BLOCK,
                        (b + 1) // RMQ_BLOCK - 1)
                out[s:s + RMQ_ROWS] = torch.minimum(
                    got, _table_min(self.table, a, b))
            return out


def doubling_round(seg, idx, slot, rank, lcp, rmq, d: int):
    """One doubling round over tied rows in slot order: every segment is
    proven equal through ``d`` symbols, every boundary of the LCP array
    lies below ``d``, and ``rank`` is as ``rank_array`` made it.

    Sorts the rows by (segment, rank of suffix ``i + d``) with the
    onesweep radix sort and the text index as payload, and splits
    segments where the ranks differ. With ``lcp``, each new boundary
    gets its exact LCP: ``d`` plus the least LCP from one past the
    lesser rank's slot through the greater's (``rmq``, answered before
    any write; 0 where the lesser suffix is past the end), written into
    ``lcp`` and ``rmq``. Only then does every row get its new segment's
    head slot in ``rank``, so each read of the round was at depth ``d``.
    Rows move only inside their segment's slot range. Returns (seg,
    idx, tied); ``seg`` and ``idx`` are consumed (sorted in place).
    Counts the rows in ``refine_doubling_rows``."""
    n = rank.shape[0] - 1
    rows = seg.shape[0]
    count("refine_doubling_rows", rows)
    key = rank[(idx.long() + d).clamp_(max=n)] + 1
    seg_bits = max(1, (rows - 1).bit_length())
    (s_seg, s_key), s_idx = radix_sort_words(
        [seg, key], idx, [seg_bits, max(1, n.bit_length())])
    parent_head = s_seg != _shift1(s_seg)
    split = (s_key != _shift1(s_key)) & ~parent_head
    new_head = parent_head | split
    del s_seg
    if lcp is not None:
        at = torch.nonzero(split).view(-1)
        if at.shape[0]:
            lo = s_key[at - 1].long()
            hi = s_key[at].long() - 1
            val = torch.where(lo > 0, rmq.query(lo, hi), 0) + d
            pos = slot[at].long()
            lcp[pos] = val
            rmq.lower(pos, val)
    heads = torch.nonzero(new_head).view(-1)   # the round's host read
    new_seg = segment_ids(new_head)
    rank[s_idx.long()] = slot[heads].to(torch.int32)[new_seg.long()]
    return new_seg, s_idx, rows - heads.shape[0]


def _doubling_rounds(sa, lcp, rows: TiedRows, rank, rmq, budget: int,
                     host_piece: int) -> int:
    """Doubling rounds (``doubling_round``) while more than
    ``host_piece`` rows are tied, at most ``budget``. Returns the rounds
    run."""
    r = 0
    while rows.tied > host_piece and r < budget:
        _compact_sparse(sa, lcp, rows)
        rows.seg, rows.idx, rows.tied = doubling_round(
            rows.seg, rows.idx, rows.slot, rank, lcp, rmq, rows.d)
        rows.d *= 2
        r += 1
    return r


def refine_ties(sa: torch.Tensor, tie: torch.Tensor,
                lcp: torch.Tensor | None, text: torch.Tensor, *,
                remap: np.ndarray, spw_main: int, nw: int, minpad: bool,
                host_text: np.ndarray, want_lcp: bool,
                meta: dict | None = None):
    """Resolve every window-tied group of a carried-keys build exactly.

    Args:
      sa:   int32[n], the build's order; tied groups in any order.
            Refined in place.
      tie:  bool[n]; tie[j]: slot j's key words equal slot j-1's.
      lcp:  int32[n] or None; tied rows hold lower bounds. Patched in
            place where ``want_lcp`` (or replaced, under minpad, by its
            clamp to the shorter suffix).
      text: uint8[n] on the device.
      remap: the dense alphabet table (codes 1..sigma), the reserved-0
            refinement table.
      spw_main, nw, minpad: the main build's packing; the verified depth
            is ``nw * spw_main`` symbols, or 0 under minpad.
      host_text: np.uint8[n] for the exact host closer.
      meta: optional dict that receives ``refine_members``,
            ``refine_pieces``, ``refine_rounds`` (the most word rounds
            of one piece plus the doubling rounds),
            ``refine_host_members`` and ``refine_phase_s`` (host seconds
            of the spans of ``REFINE_PHASES``).

    Counts ``refine_word_rounds`` (over all pieces),
    ``refine_doubling_rounds``, ``refine_depth`` (the deepest depth the
    rounds proved) and, where the doubling runs,
    ``refine_doubling_rows`` (the rows its rounds sorted) and
    ``rmq_ranges`` (the ranges RangeMin answered). Returns (sa, lcp).
    Raises RefineOverflow when a cap is exceeded."""
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


# ``refine_phase_s``' keys and the spans they read. "refine: rounds"
# holds both kinds of round and, inside it, "refine: ranks" (the rank
# array and RangeMin's construction) and "refine: doubling" (the
# doubling rounds). Every piece of RangeMin's work (its construction,
# each query and each lower) is the device span "refine: rmq".
REFINE_PHASES = {"extract": "refine: extract", "pk": "refine: pair_table",
                 "rounds": "refine: rounds", "host_fetch": "refine: fetch"}


def _refine(sa, tie, lcp, text, remap, spw_main: int, nw: int,
            minpad: bool, host_text, want_lcp: bool, meta: dict):
    knobs = refine_knobs()
    n, dev = sa.shape[0], sa.device
    bits, spw = refine_packing(int(remap.max()))
    # Every boundary the keys decided has an LCP below their window, and
    # every group (under minpad once its short members are set apart) is
    # equal through it: whole groups of that depth, where the rounds
    # start.
    window = nw * spw_main
    cap, host_piece = knobs["rounds"], knobs["host_piece"]
    if not want_lcp:
        lcp = None

    with span("refine: extract"):
        slots, heads = extract_ties(tie)
        meta.update(refine_members=slots.shape[0], refine_pieces=0,
                    refine_rounds=0, refine_host_members=0)
        if slots.shape[0] == 0:
            return sa, lcp
        if minpad:
            _set_short_apart(sa, lcp, slots, heads, window)
        slots = slots.to(torch.int32)
        bounds = piece_bounds(heads, knobs["piece"])
        sizes = np.diff(bounds)
        if sizes.max() > knobs["group_max"]:
            raise RefineOverflow(
                f"a refinement piece holds {int(sizes.max())} tied members "
                f"(> SA_REFINE_GROUP_MAX={knobs['group_max']}): one tie "
                "group exceeds the device sort budget")
        meta["refine_pieces"] = len(sizes)
        sync(dev)

    # Word rounds deepen each piece while its tied rows exceed their
    # share of one piece, and while a round still cuts them fourfold:
    # shallow ties (words) end there, cheaper than a rank array of n.
    # Deep ones (repeat copies) stall, and the doubling takes them.
    share = knobs["piece"] // len(sizes)
    pk2 = None
    if sizes.max() > host_piece:
        with span("refine: pair_table"):
            pk2 = pair_table(text, remap)
            sync(dev)

    def deepen(rows, r):
        return rows.tied > host_piece and (
            r == 0 or rows.tied > share or 4 * rows.tied <= rows.before)

    left, words = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        with span("refine: rounds"):
            slot = slots[a:b]
            rows = TiedRows(slot, sa[slot.long()], heads[a:b], window)
            words.append(_word_rounds(sa, lcp, rows, pk2, spw, bits, cap,
                                      deepen))
        with span("refine: fetch"):
            left.append(_settle(sa, lcp, rows))
    del slots, heads

    depth = max([window] + [p[3] for p in left if p[0].shape[0]])
    if pk2 is not None and sum(p[0].shape[0] for p in left) > host_piece:
        # One rank array serves every segment: bring all to one depth.
        with span("refine: rounds"):
            for i, (slot, idx, head, d) in enumerate(left):
                if slot.shape[0] and d < depth:
                    rows = TiedRows(slot, idx, head, d)
                    words[i] += _word_rounds(
                        sa, lcp, rows, pk2, spw, bits, cap - words[i],
                        lambda rows, r: rows.d < depth)
                    left[i] = _settle(sa, lcp, rows)
    del pk2
    parts = [p for p in left if p[0].shape[0]]
    doubles = 0
    if (sum(p[0].shape[0] for p in parts) > host_piece
            and all(p[3] == depth for p in parts)):
        with span("refine: rounds"):
            slot, idx, head = (torch.cat([p[j] for p in parts])
                               for j in range(3))
            del parts, left
            with span("refine: ranks"):
                rank = rank_array(sa, slot, idx, head)
                rmq = None
                if lcp is not None:
                    if minpad:
                        # The keys' LCPs overshoot where a suffix ends
                        # inside the window; no tied row is that short.
                        lcp = clamp_lcp(sa, lcp, n)
                    lcp[slot[~head].long()] = UNKNOWN
                    rmq = RangeMin(lcp)
                sync(dev)
            rows = TiedRows(slot, idx, head, depth, patch=False)
            del slot, idx, head
            with span("refine: doubling", dev):
                doubles = _doubling_rounds(sa, lcp, rows, rank, rmq, cap,
                                           host_piece)
            del rank, rmq
        with span("refine: fetch"):
            left = [_settle(sa, lcp, rows)]

    with span("refine: fetch"):
        tied = max(p[0].shape[0] for p in left)
        if tied > 4 * host_piece:
            raise RefineOverflow(
                f"{tied} members still tied after {max(words)} word and "
                f"{doubles} doubling refinement rounds "
                "(> 4*SA_REFINE_HOST_PIECE)")
        # The segments, each tied through the d symbols the rounds
        # proved, go to the host closer as they are.
        host_patches = [(slot.cpu().numpy(), idx.cpu().numpy(),
                         head.cpu().numpy(), d)
                        for slot, idx, head, d in left if slot.shape[0]]
        sa, lcp, n_host = apply_residue(sa, lcp, host_text, host_patches,
                                        n, want_lcp)
        sync(dev)
    meta["refine_rounds"] = max(words) + doubles
    meta["refine_host_members"] = n_host
    count("refine_word_rounds", sum(words))
    count("refine_doubling_rounds", doubles)
    count("refine_depth", max(p[3] for p in left))
    return sa, lcp
