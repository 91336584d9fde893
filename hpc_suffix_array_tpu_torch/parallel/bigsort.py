"""Sharded carried-keys builder: SA (and LCP) from one distributed sort.

Counterpart of ``hpc_suffix_array_tpu/parallel/bigsort.py``: its
host-text entry (``build_suffix_array_sharded_big``) and its
multi-process entry (``build_suffix_array_sharded_big_mp``). Where the
sharded doubling builder (``parallel/doubling.py``) pays a
block-bitonic sort per round, texts whose suffixes separate within the
first ``nw*spw`` symbols (random, DNA and, in chain mode, periodic
text) need ONE distributed sort of the carried key words:

  1. *Plan (host)*: the alphabet, the repeat estimate, the carried word
     count ``nw`` (2, or 3 when the 2-word residue overflows the mesh's
     extraction budget) and the chain prediction (``est_repeat >
     nw*spw``, the JAX package's gate).
  2. *Keys (device, per shard)*: one K1 launch (``kernels/pack.py::
     pack_words``) writes the shard's ``nw`` words from its bytes and an
     ``nw*spw``-byte halo from the next shard (one ``ppermute``); pad
     rows get ``PAD_KEY`` words, so they sort last.
  3. *Sort*: ``parallel/bitonic.py::block_bitonic_sort`` of the
     keys-only block (k0, k1[, k2], tb). The tiebreak ``tb`` is the
     position (descending in chain mode: ``n - g``), unique per row, so
     it is both the last key and the index, and the order is total.
  4. *Post-sort pass (device, plain PyTorch)*: the tie flags against the
     global predecessor (the left neighbour's last row comes by one
     ``ppermute``, ``_boundary_prev``), the chain deltas and the LCP from
     xor and the highest set bit (``_key_lcp``); the tie count, the
     delta min and max, the residue total and the overflow flag are
     reduced over the shards and read on the host once an attempt
     (``read_scalar``).
  5. *Chain mode / residue*: a uniform chain delta that is a global
     period finishes periodic text by the chain rule; otherwise each
     shard compacts at most ``RESIDUE_SLOTS`` tie-group members, the host
     orders them (``core/bigsort.py::_resolve_residue_host``) and the
     patches land per shard (``_group_patches``, pads dropped). The
     JAX package's retry graph is kept: a chain misprediction reruns
     ascending, and an ascending run tied on more than a quarter of the
     text reruns in chain mode. What it cannot finish raises
     NotImplementedError, and the callers fall back to doubling.

Two text-access strategies (``tops``) drive the same orchestration
(``_build``):

  * ``_HostText``: every process holds the whole text. Alphabet, repeat
    estimate, feasibility and residue resolution read the host copy;
    the result comes back whole.
  * ``_DistText`` (the ``_mp`` entry): each process holds ONLY its block
    of the padded text (``mp_local_geometry``). The alphabet is a
    256-bin presence psum'd over the shards (``_present``), the repeat
    estimate the max over processes of each block's own, the period
    check a d-shifted compare across shard edges (``_period``), and the
    residue's extension steps read text windows through distributed
    gathers (``_window``, ``_GatheredView``): a tie deeper than
    ``DEEP_WIN`` bytes raises NotImplementedError. Every host branch
    reads a reduced value, the same on every process, so all processes
    stay in lockstep. The result stays padded and sharded.

Under ``wide_index`` the outputs are int64 and ``tb`` is read as an
unsigned 32-bit key, so the padded length must stay below 2^32 (the JAX
package's two-word (hi, lo) index arithmetic is not needed with int64).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.bigsort import (
    RESIDUE_SLOTS, ResidueDepthError, _apply_patch, _period_mismatches,
    _resolve_residue_host, deep_repeat_class, estimate_repeat_len, key_table,
    packing_mode, residue_feasible, residue_feasible_sigma)
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    PRESENCE_CHUNK, alphabet_remap, alphabet_remap_dev, as_byte_array,
    remap_from_present)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words
from hpc_suffix_array_tpu_torch.kernels.post_sort import _high_bit
from hpc_suffix_array_tpu_torch.parallel.bitonic import block_bitonic_sort
from hpc_suffix_array_tpu_torch.parallel.doubling import (
    padded_shards, text_length)
from hpc_suffix_array_tpu_torch.parallel.gather import dist_gather
from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, bucket_size, first_local, local_ids, make_mesh, padded_length,
    pmax, pmin, ppermute, psum, read_scalar, shard_iota, smap, unshard)

PAD_KEY = 1 << 30      # pad rows' key words: above every packed word
_BIG = 1 << 30         # the delta minimum's fill where a shard has no tie


def sharded_msd_min() -> int:
    """Texts from this many bytes (``SA_SHARDED_MSD_MIN``, 4 MiB, a
    threshold set on a TPU) first try the carried-keys builder."""
    return int(os.environ.get("SA_SHARDED_MSD_MIN", 1 << 22))


def try_carried_keys(text, n: int) -> bool:
    """The JAX routers' gate: from ``sharded_msd_min()`` bytes, and from
    ``SA_SHARDED_CHAIN_MIN`` (64 KiB, a threshold set on a TPU) for
    deep-repeat text (one host copy of a tensor's bytes for the repeat
    estimate)."""
    if n >= sharded_msd_min():
        return True
    return (n >= int(os.environ.get("SA_SHARDED_CHAIN_MIN", 1 << 16))
            and deep_repeat_class(estimate_repeat_len(as_byte_array(text))))


def _boundary_prev(cols: list[list[torch.Tensor]]) -> list[torch.Tensor]:
    """Each shard's view of its left neighbour's LAST sorted row:
    ``cols`` are sharded columns of one dtype; shard i receives a
    [len(cols)] packet. Shard 0 receives zeros, which under minpad
    packing CAN equal a real row (an all-min-symbol suffix packs to 0),
    so callers mask the first global row themselves."""
    packets = [None if c is None else torch.stack([col[me][-1]
                                                   for col in cols])
               for me, c in enumerate(cols[0])]
    return ppermute(packets, [(i, i + 1) for i in range(len(packets) - 1)])


def _pack_words(texts: list[torch.Tensor], table, bits: int, spw: int,
                nw: int, n_real: int) -> list[list[torch.Tensor]]:
    """The ``nw`` carried key words of each shard (int32[m] each), one K1
    launch per shard over its bytes and the next shard's first
    ``nw*spw`` (the last shard gets zeros); codes past ``n_real`` read
    0."""
    P, m = len(texts), first_local(texts).shape[0]
    halo = ppermute(smap(lambda t: t[:nw * spw], texts),
                    [(i, i - 1) for i in range(1, P)])
    out = [None] * P
    for me in local_ids(texts):
        ext = torch.cat([texts[me], halo[me]])
        real = min(max(n_real - me * m, 0), ext.shape[0])
        out[me] = pack_words(ext, table.to(ext.device), bits, spw, real, nw,
                             n_out=m)
    return out


def _key_lcp(prev_words, sorted_words, spw: int, bits: int, nw: int):
    """First-mismatch depth (symbols) of adjacent sorted carried keys:
    xor and the highest set bit per word (symbols pack first-highest in
    the low spw*bits bits); fully equal rows keep the nw*spw lower bound
    (the chain rule or the host residue finishes them)."""
    depth = nw * spw
    lcp = torch.full_like(sorted_words[0], depth)
    for w in range(nw - 1, -1, -1):
        x = prev_words[w] ^ sorted_words[w]
        off = (w + 1) * spw - 1 - torch.div(_high_bit(x), bits,
                                            rounding_mode="floor")
        lcp = torch.where(x != 0, off, lcp)
    return lcp.clamp_(min=0)


def _local_build(bits: int, spw: int, R: int, nw: int, minpad: bool,
                 texts: list[torch.Tensor], remap: np.ndarray, n_real: int,
                 desc: bool, wide: bool = False, want_lcp: bool = True):
    """Carried keys, one distributed sort, tie flags, LCP and residue.

    ``texts``: the sharded padded text (uint8, m per shard). Returns
    (s_idx, lcp, members, stats): sharded int32 (int64 when ``wide``)
    suffix array rows and LCP (None without ``want_lcp``), the sharded
    bool mask of tie-group members (``_residue`` compacts them), and
    ``stats`` int64[6] = (tie count, delta max, delta min, residue
    total, shards over R, 0), reduced over the shards as in the JAX
    package (the same on every process). Pad rows sort last and hold
    ``n_real``; ``lcp[j] = LCP(sa[j-1], sa[j])``, with 0 at row 0 and on
    pad rows."""
    P, m = len(texts), first_local(texts).shape[0]
    mine = local_ids(texts)
    idx_t = torch.int64 if wide else torch.int32
    table = key_table(remap, minpad, first_local(texts).device)
    words = _pack_words(texts, table, bits, spw, nw, n_real)
    blocks = [None] * P
    for me in mine:
        g = shard_iota(me, m, texts[me].device).to(idx_t)
        real = g < n_real
        rows = [torch.where(real, w, PAD_KEY) for w in words[me]]
        # Pads' tiebreak is their position: their words already put them
        # last, and a small tiebreak keeps its live bits few.
        tb = torch.where(real & desc, n_real - g, g)
        blocks[me] = torch.stack(rows + [tb.to(torch.int32)])
    del words
    live = [31] * nw + [max(1, max(P * m - 1, n_real).bit_length())]
    out = block_bitonic_sort(blocks, nw + 1, live)
    del blocks

    sw = [smap(lambda b, w=w: b[w], out) for w in range(nw)]
    tbs = smap(lambda b: b[nw], out)
    bprev = _boundary_prev(sw + [tbs])

    def index(tb):
        t = tb.to(torch.int64) & 0xFFFFFFFF if wide else tb
        return (n_real - t if desc else t).to(idx_t)

    fill = (1 << 62) if wide else _BIG
    s_idx, lcps, ties, real_l, tie_cnt, dmax, dmin = (
        [None] * P for _ in range(7))
    for me in mine:
        gpos = shard_iota(me, m, out[me].device).to(idx_t)
        real_s = gpos < n_real                           # pads sort last
        s = torch.where(real_s, index(tbs[me]), n_real)
        prev_w = [torch.cat([bprev[me][w:w + 1], sw[w][me][:-1]])
                  for w in range(nw)]
        prev_idx = torch.cat([index(bprev[me][nw:]), s[:-1]])
        tie = real_s & (gpos > 0)
        for w in range(nw):
            tie &= sw[w][me] == prev_w[w]
        delta = (prev_idx - s) if desc else (s - prev_idx)
        tie_cnt[me] = tie.sum()
        dmax[me] = torch.where(tie, delta, 0).max().long()
        dmin[me] = torch.where(tie, delta, fill).min().long()
        if want_lcp:
            lcp = _key_lcp(prev_w, [c[me] for c in sw], spw, bits,
                           nw).to(idx_t)
            if desc:       # periodic ties: chain members are consecutive
                lcp = torch.where(tie, n_real - prev_idx, lcp)
            # Row 0's manufactured predecessor and pad rows read 0.
            lcps[me] = torch.where(real_s & (gpos > 0), lcp, 0)
        s_idx[me] = s
        ties[me] = tie
        real_l[me] = real_s
    del out, sw, tbs

    # Residue membership: every element of a tied group (the flag marks
    # the later row of each tied pair; a group's head joins through its
    # successor's flag, pulled across the right boundary).
    nxt = ppermute(smap(lambda t: t[:1], ties),
                   [(i, i - 1) for i in range(1, P)])
    members = smap(lambda t, x, r: (t | torch.cat([t[1:], x])) & r,
                   ties, nxt, real_l)
    res_cnt = smap(torch.sum, members)
    stats = torch.stack([
        first_local(psum(tie_cnt)), first_local(pmax(dmax)),
        first_local(pmin(dmin)), first_local(psum(res_cnt)),
        first_local(psum(smap(lambda c: (c > R).long(), res_cnt))),
        torch.zeros_like(first_local(res_cnt))])
    return s_idx, (lcps if want_lcp else None), members, stats


def _residue(members: list[torch.Tensor], s_idx: list[torch.Tensor],
             R: int):
    """Each shard's first ``R`` tie-group members (the JAX package's
    fixed-size compaction without its pad rows): their global sorted
    slots (int64) and suffix indices, sharded. One host read per local
    shard (its member count); runs only where the residue is resolved."""
    slots, idx = [None] * len(members), [None] * len(members)
    for me in local_ids(members):
        mem = members[me]
        loc = torch.nonzero(mem).view(-1)[:R]
        slots[me] = loc + me * mem.shape[0]
        idx[me] = s_idx[me][loc]
    return slots, idx


def _group_patches(slots_g: np.ndarray, vals: np.ndarray, P: int, m: int,
                   R: int):
    """Group global-slot patches by owning shard into (P*R,) padded
    (local slot, value) arrays: shard p's rows are [p*R, (p+1)*R), -1
    slots are pads."""
    out_s = np.full(P * R, -1, np.int64)
    out_v = np.zeros(P * R, np.int64)
    sh = (slots_g // m).astype(np.int64)
    loc = (slots_g % m).astype(np.int64)
    for p_ in range(P):
        idx = np.flatnonzero(sh == p_)
        if len(idx) > R:
            raise RuntimeError("per-shard residue cap violated")
        out_s[p_ * R:p_ * R + len(idx)] = loc[idx]
        out_v[p_ * R:p_ * R + len(idx)] = vals[idx]
    return out_s, out_v


def _patch(col: list[torch.Tensor], ps: np.ndarray, pv: np.ndarray,
           R: int) -> None:
    """Each local shard writes its own R (local slot, value) rows, pads
    dropped (``core/bigsort.py::_apply_patch``), in place."""
    for me in local_ids(col):
        c = col[me]
        _apply_patch(c, torch.as_tensor(ps[me * R:(me + 1) * R]).to(c.device),
                     torch.as_tensor(pv[me * R:(me + 1) * R]).to(c.device))


def _clamp_lcp_sharded(sa: list[torch.Tensor], lcp: list[torch.Tensor],
                       n: int) -> list[torch.Tensor]:
    """``core/bigsort.py::_clamp_lcp`` on sharded columns: lcp[j] <= n -
    max(sa[j-1], sa[j]). Row 0 meets shard 0's zero packet, which loses
    the max to sa[0] as the whole-array form's self-pairing does; pad
    rows (sa = n) clamp to 0, which they already hold. Runs after the
    residue patch."""
    prev = _boundary_prev([sa])

    def clamp(s, p, c):
        before = torch.cat([p.to(s.dtype), s[:-1]])
        return torch.minimum(c, n - torch.maximum(before, s))

    return smap(clamp, sa, prev, lcp)


class _HostText:
    """Text access strategy: every process holds the whole text.

    Alphabet, repeat estimate, residue feasibility and residue
    resolution read the host copy (one device-to-host copy when the text
    is a tensor); the period check runs on the device; the text is
    sharded once, from the tensor's device or staged from the host."""

    slice_output = True          # return whole arrays sliced to [:n]

    def __init__(self, text, mesh: Mesh):
        self.mesh = mesh
        self.P = mesh.size
        self.n = text_length(text)
        self.n_pad = bucket_size(self.n, multiple_of=self.P * 128)
        if self.n_pad >= 1 << 32:
            raise ValueError(f"n={self.n} pads to {self.n_pad} positions; "
                             "the sharded carried-keys builder reads its "
                             "tiebreak as uint32 and needs fewer than 2^32")
        self.m = self.n_pad // self.P
        self.arr = as_byte_array(text)
        if isinstance(text, torch.Tensor):
            self.remap, _, _ = alphabet_remap_dev(text.to(torch.uint8))
        else:
            self.remap, _, _ = alphabet_remap(self.arr)
        self.sigma = int(self.remap.max())
        self.est_repeat = estimate_repeat_len(self.arr)
        self.texts = padded_shards(text, self.n_pad, mesh)
        self._text_t = text if isinstance(text, torch.Tensor) else None

    def feasible(self, words: int, cap: float, spw: int) -> bool:
        # Module-global lookup on purpose: tests monkeypatch
        # parallel.bigsort.residue_feasible to force the 3-word gate.
        return residue_feasible(self.arr, self.n, cap, self.est_repeat,
                                words=words, spw=spw, sigma=self.sigma)

    def fetch(self, xs: list[torch.Tensor]) -> np.ndarray:
        return unshard(xs).cpu().numpy()

    def period_holds(self, d: int) -> bool:
        if self._text_t is None:
            self._text_t = unshard(self.texts)[:self.n]
        return _period_mismatches(self._text_t, d, self.n) == 0

    def view(self):
        return self.arr       # _resolve_residue_host wraps it in _ArrView


def _present(texts: list[torch.Tensor], n: int) -> list[torch.Tensor]:
    """JAX ``_present_kernel``: a 256-bin presence mask of the real bytes
    (positions below ``n``) per shard, psum'd over the shards: int64[256]
    on every shard, the same on every process."""
    m = first_local(texts).shape[0]
    out = [None] * len(texts)
    for me in local_ids(texts):
        t = texts[me][:min(max(n - me * m, 0), m)]
        counts = torch.zeros(256, dtype=torch.int64, device=t.device)
        for i in range(0, t.shape[0], PRESENCE_CHUNK):
            counts += torch.bincount(t[i:i + PRESENCE_CHUNK].long(),
                                     minlength=256)
        out[me] = (counts > 0).to(torch.int32)
    return psum(out)


def _period(texts: list[torch.Tensor], d: int, n: int) -> list[torch.Tensor]:
    """JAX ``_period_kernel``: the count of shards that saw some t < n - d
    with text[t] != text[t + d], replicated (0 iff ``d`` is a period).

    The whole-shard part q of the shift d = q*m + r is a butterfly of
    ring rotations (one per set bit of q; ``d`` is a host integer, so a
    clear bit is skipped instead of masked), the remainder one halo
    ``ppermute`` and a slice at r. Positions past n - d are excluded,
    which also voids every rotation that wrapped around the ring."""
    P, m = len(texts), first_local(texts).shape[0]
    q, r = divmod(int(d), m)
    blk = texts
    b = 0
    while (1 << b) < P:
        if (q >> b) & 1:
            blk = ppermute(blk, [(i, (i - (1 << b)) % P) for i in range(P)])
        b += 1
    nxt = ppermute(blk, [(i, (i - 1) % P) for i in range(P)])
    out = [None] * P
    for me in local_ids(texts):
        k = min(max(n - d - me * m, 0), m)
        shifted = torch.cat([blk[me], nxt[me]])[r:r + k]
        out[me] = (texts[me][:k] != shifted).any().to(torch.int32)
    return psum(out)


def _window(texts: list[torch.Tensor], q: np.ndarray, off: np.ndarray,
            W: int, RW: int) -> list[torch.Tensor]:
    """JAX ``_window_kernel``: replicated ``W``-byte text windows at
    the U query positions ``q * RW + off`` (host arrays, the same on
    every process; ``RW`` a power of two dividing the shard width m and
    W). Each query gathers W // RW + 1 consecutive RW-byte rows through
    ``dist_gather`` (every shard asks the same rows, so every shard ends
    with the same answer) and cuts its window out locally: uint8[U, W]
    on every shard. Rows past the padded text read 0."""
    m = first_local(texts).shape[0]
    rows = smap(lambda t: t.view(m // RW, RW), texts)
    qs = smap(lambda t: torch.as_tensor(q, dtype=torch.int32).to(t.device),
              texts)
    parts = [dist_gather(rows, smap(lambda x, j=j: x + j, qs))
             for j in range(W // RW + 1)]

    def cut(t, *got):
        both = torch.cat(got, dim=1)                     # (U, W + RW)
        cols = (torch.as_tensor(off, dtype=torch.int64).to(t.device)[:, None]
                + torch.arange(W, device=t.device)[None, :])
        return torch.gather(both, 1, cols)

    return smap(cut, texts, *parts)


class _GatheredView:
    """Bounded-window text view for residue resolution (multi-process).

    Serves the ``_ArrView`` contract (``core/bigsort.py``) from window
    gathers: each ``fetch`` is one gather of the closer's extension
    step. ``DEEP_WIN`` bounds the depth the closer reads: a tie deeper
    than that raises ResidueDepthError, which the caller turns into
    NotImplementedError and the doubling fallback."""

    DEEP_WIN = 4096

    def __init__(self, tops: "_DistText"):
        self.tops = tops
        self.n = tops.n

    def fetch(self, starts: np.ndarray, K: int) -> np.ndarray:
        return self.tops.gather_windows(np.asarray(starts, np.int64), K)


class _DistText:
    """Text access strategy: every process holds ONLY its local block.

    The global questions go through collectives on the sharded text
    (presence psum, shifted compare, window gathers); host work touches
    only the local block. Every host decision reads a reduced value, the
    same on every process, so all processes branch alike."""

    slice_output = False         # return PADDED sharded arrays

    def __init__(self, local_block, n: int, mesh: Mesh):
        from hpc_suffix_array_tpu_torch.parallel.multihost import (
            host_local_shard)

        self.mesh = mesh
        self.P = mesh.size
        self.n = n
        self.n_pad = bucket_size(n, multiple_of=self.P * 128)
        if self.n_pad >= 1 << 32:
            raise ValueError(f"n={n} pads to {self.n_pad} positions; the "
                             "sharded carried-keys builder reads its "
                             "tiebreak as uint32 and needs fewer than 2^32")
        self.m = m = self.n_pad // self.P
        start, stop = host_local_shard(self.n_pad, mesh)
        block = torch.as_tensor(local_block)
        if block.dtype != torch.uint8 or tuple(block.shape) != (
                stop - start,):
            raise ValueError(
                f"local block {block.dtype}{tuple(block.shape)} is not this "
                f"process's uint8[{stop - start}]: size it with "
                "mp_local_geometry(n, mesh)")
        self.texts = [None] * self.P
        for j, i in enumerate(mesh.local_ids):
            self.texts[i] = block[j * m:(j + 1) * m].to(mesh.device_of(i),
                                                       copy=True)
        present = first_local(_present(self.texts, n)).cpu().numpy() > 0
        self.remap, _, _ = remap_from_present(present)
        self.sigma = int(self.remap.max())
        # Repeat estimate: each process's own block, the max over
        # processes. A block sees any period shorter than itself, which
        # is all the router needs; a miss flips chain mode late through
        # the reduced tie stats (the misprediction retry), never wrongly.
        take = max(0, min(stop, n) - start)
        est = estimate_repeat_len(block[:take].numpy())
        self.est_repeat = int(first_local(pmax(smap(
            lambda t: torch.tensor(est, device=t.device), self.texts))))

    def feasible(self, words: int, cap: float, spw: int) -> bool:
        return residue_feasible_sigma(self.sigma, self.n, cap,
                                      self.est_repeat, words=words, spw=spw)

    def fetch(self, xs: list[torch.Tensor]) -> np.ndarray:
        return unshard(xs).cpu().numpy()      # every process gets it all

    def period_holds(self, d: int) -> bool:
        return int(first_local(_period(self.texts, d, self.n))) == 0

    def view(self):
        return _GatheredView(self)

    def gather_windows(self, idxs: np.ndarray, W: int) -> np.ndarray:
        """uint8[len(idxs), W] text windows (0 past the end of the
        text)."""
        RW = min(W & -W, self.m & -self.m)    # a power of two dividing m, W
        win = first_local(_window(self.texts, (idxs // RW).astype(np.int32),
                                  idxs % RW, W, RW)).cpu().numpy()
        rel = np.arange(W, dtype=np.int64)[None, :]
        return np.where(idxs[:, None] + rel < self.n, win, np.uint8(0))


def wide_auto(n_pad: int) -> bool:
    """Wide (int64) indices when any padded index could reach int32's
    edge (the JAX package's boundary)."""
    return n_pad >= (1 << 31) - 1


def mp_local_geometry(n: int, mesh: Mesh) -> tuple[int, int, int]:
    """(n_pad, start, stop): the padded text length of ``mesh`` and the
    [start, stop) block of it this process passes to
    ``build_suffix_array_sharded_big_mp`` (zeros past n)."""
    from hpc_suffix_array_tpu_torch.parallel.multihost import (
        host_local_shard)

    n_pad = bucket_size(n, multiple_of=mesh.size * 128)
    start, stop = host_local_shard(n_pad, mesh)
    return n_pad, start, stop


def build_suffix_array_sharded_big(text, mesh: Mesh | None = None,
                                   force_chain_mode: bool | None = None,
                                   wide_index: bool | None = None,
                                   want_lcp: bool = False,
                                   info: dict | None = None):
    """Suffix array of ``text`` (str, bytes, uint8 array or tensor) from
    ONE distributed carried-keys sort over ``mesh`` (default: one shard
    per visible card), returned whole on the mesh's first device: int32
    [n], or int64 under ``wide_index`` (default: ``wide_auto`` of the
    padded length). ``want_lcp``: return ``(sa, lcp)``, the LCP from the
    sorted keys (xor and highest bit, the chain rule, residue patches).

    Raises NotImplementedError where the ties exceed the bounded residue
    and are no clean periodic chain: callers fall back to the doubling
    builder. ``info``: optional dict that receives ``chain_mode`` and
    ``n_words`` of the attempt that finished and adds the distributed
    sorts run to ``msd_sorts``.

    This entry needs the whole text in every process. Where no process
    holds it, use ``build_suffix_array_sharded_big_mp``."""
    mesh = make_mesh() if mesh is None else mesh
    if text_length(text) < 8:
        raise ValueError("sharded bigsort needs n >= 8; use the doubling "
                         "builder")
    tops = _HostText(text, mesh)
    return _build(tops, force_chain_mode, wide_index, want_lcp, info)


def build_suffix_array_sharded_big_mp(local_block, n: int,
                                      mesh: Mesh | None = None,
                                      force_chain_mode: bool | None = None,
                                      wide_index: bool | None = None,
                                      want_lcp: bool = False,
                                      info: dict | None = None):
    """The carried-keys build where NO process holds the whole text.

    Each process passes only its own block of the padded text
    (``local_block``, uint8 numpy or tensor): ``mp_local_geometry(n,
    mesh)`` gives its [start, stop); bytes past n are zeros. Alphabet,
    repeat estimate, chain-period check and residue resolution run
    through collectives on the sharded text (``_DistText``), and every
    host branch reads a reduced value, so all processes stay in
    lockstep. Every process of ``mesh`` must call it with the same
    ``n`` and options.

    Returns PADDED sharded arrays (lists of P slots, None for other
    processes' shards; rows [0, n) are the result, pad rows of the SA
    hold n): ``sa`` or ``(sa, lcp)``, int32, or int64 under
    ``wide_index``. Raises NotImplementedError, on every process, on
    irregular massive ties and on residue pairs tied past
    ``_GatheredView.DEEP_WIN`` bytes: callers fall back to the doubling
    builder over the whole text. ``info`` as in
    ``build_suffix_array_sharded_big``."""
    mesh = make_mesh() if mesh is None else mesh
    if int(n) < 8:
        raise ValueError("sharded bigsort needs n >= 8; use the doubling "
                         "builder")
    tops = _DistText(local_block, int(n), mesh)
    try:
        return _build(tops, force_chain_mode, wide_index, want_lcp, info)
    except ResidueDepthError as e:
        raise NotImplementedError(
            f"sharded bigsort[mp]: {e} - use the doubling builder") from e


def _build(tops, force_chain_mode, wide_index, want_lcp, info=None):
    """Shared orchestration over a text-access strategy (``tops``)."""
    bits, spw, minpad = packing_mode(tops.remap)
    # Carried word count: 2, or 3 when the 2-word expected residue
    # overflows the mesh-wide extraction budget and 3 words' fits.
    cap_total = tops.P * RESIDUE_SLOTS / 4
    nw = 2
    if not tops.feasible(2, cap_total, spw):
        if tops.feasible(3, cap_total, spw):
            nw = 3
    chain = force_chain_mode
    if chain is None:
        chain = tops.est_repeat > nw * spw
    if wide_index is None:
        wide_index = wide_auto(tops.n_pad)
    build = _build_wide if wide_index else _build_narrow
    return build(tops, bits, spw, minpad, nw, chain, force_chain_mode,
                 want_lcp, info)


def _build_narrow(tops, *plan):
    """int32 outputs; the padded length stays below 2^31."""
    padded_length(tops.n, tops.P)
    return _attempt(tops, *plan, wide=False)


def _build_wide(tops, *plan):
    """int64 outputs (the strategies hold the padded length below
    2^32)."""
    return _attempt(tops, *plan, wide=True)


def _attempt(tops, bits, spw, minpad, nw, chain, force_chain_mode, want_lcp,
             info, wide):
    """One distributed sort and what it leaves: the chain check, the
    JAX package's retries, the residue patch and the minpad clamp."""
    n, P, m = tops.n, tops.P, tops.m
    R = RESIDUE_SLOTS
    s_idx, lcp_d, members, stats = _local_build(
        bits, spw, R, nw, minpad, tops.texts, tops.remap, n, chain, wide,
        want_lcp)
    tie_cnt, dmax, dmin, _res_total, overflow, _ = read_scalar(stats)
    if info is not None:
        info["msd_sorts"] = info.get("msd_sorts", 0) + 1

    def retry(chain_mode: bool):
        del s_idx[:], members[:]
        if lcp_d is not None:
            del lcp_d[:]
        return _build(tops, chain_mode, wide, want_lcp, info)

    def finish():
        if info is not None:
            info.update(chain_mode=bool(chain), n_words=nw)
        sa, lcp = s_idx, lcp_d
        if want_lcp and minpad:     # after the residue patch (_clamp_lcp)
            lcp = _clamp_lcp_sharded(sa, lcp, n)
        if tops.slice_output:
            sa = unshard(sa)[:n]
            lcp = unshard(lcp)[:n] if want_lcp else None
        return (sa, lcp) if want_lcp else sa

    if chain:
        if tie_cnt:
            if not (dmin == dmax and dmax >= 1):
                if force_chain_mode is None and tie_cnt <= n // 4:
                    return retry(False)
                raise NotImplementedError(
                    "sharded bigsort: residual ties are not uniform "
                    "arithmetic chains - use the doubling builder")
            if not tops.period_holds(dmax):
                if force_chain_mode is None and tie_cnt <= n // 4:
                    # Uniform deltas that are NOT a global period (a
                    # min-symbol tail under minpad, one long repeated
                    # block): a chain misprediction, rerun ascending.
                    return retry(False)
                raise NotImplementedError(
                    f"sharded bigsort: chain delta {dmax} is not a global "
                    "period - use the doubling builder")
        return finish()

    if tie_cnt > n // 4 and force_chain_mode is None:
        return retry(True)
    if overflow:
        raise NotImplementedError(
            "sharded bigsort: window-tied elements exceed the per-shard "
            "residue cap - use the doubling builder")
    if tie_cnt:
        slots, res_idx = _residue(members, s_idx, R)
        s_sorted, fixed, ls, lv = _resolve_residue_host(
            tops.view(), tops.fetch(slots), tops.fetch(res_idx), n,
            want_lcp=want_lcp)
        ok = s_sorted < n          # pads never join groups, but guard
        _patch(s_idx, *_group_patches(s_sorted[ok], fixed[ok], P, m, R), R)
        if want_lcp and len(ls):
            ok_l = ls < n
            _patch(lcp_d, *_group_patches(ls[ok_l], lv[ok_l], P, m, R), R)
    return finish()
