"""Fully sharded LCP construction (distributed PLCP).

Counterpart of ``hpc_suffix_array_tpu/parallel/lcp.py``: the PLCP rounds
of ``core/lcp.py`` (verified extension, monotone propagation, pointer
jumping) with every array block-sharded over the mesh:

  * setup: the inverse SA by ring scatter of a global permutation, phi
    by ring gather (``parallel/gather.py``);
  * propagation: a local running max plus an ``all_gather`` of the P
    shard maxima, a cross-shard prefix max;
  * pointer jumping: one three-column ring gather per step for (phi,
    cur, resolved) at the jump targets;
  * extension: ``CMP_WIDTH`` bytes per unresolved position, in chunks of
    about 2^20 compared bytes, each a pair of text-window ring gathers;
  * convergence: ``psum`` of the unresolved count, read on the host once
    a round (``read_scalar``);
  * the permute back to SA order is one more ring gather, and lcp[0] = 0.

The output equals ``core/lcp.py``'s and Kasai's on the real text. As
in the JAX package, texts above ``SA_LCP_BIG_MIN`` whose residue fits
the mesh's extraction caps are rebuilt by the sharded carried-keys
builder with ``want_lcp`` (``parallel/bigsort.py``); the PLCP rounds
take what it refuses, and the rest.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.core.lcp import lcp_big_min
from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_array
from hpc_suffix_array_tpu_torch.parallel.doubling import (
    padded_shards, text_length)
from hpc_suffix_array_tpu_torch.parallel.gather import (
    dist_gather, dist_scatter_perm)
from hpc_suffix_array_tpu_torch.parallel.mesh import (
    Mesh, all_gather, first_local, local_ids, local_iota, make_mesh,
    padded_length, psum, read_scalar, shard, smap, unshard)

CMP_WIDTH = 16   # bytes compared per unresolved position per round
JUMP_STEPS = 2
INT32_FLOOR = -2**31 + 1


def chunk_count(m: int) -> int:
    """Extension chunks per shard: a power of two dividing m, sized so a
    chunk's text-window requests stay about 2^20 elements."""
    t2 = m & -m
    want = max(1, (m * CMP_WIDTH) >> 20)
    nc = 1
    while nc < want and nc < t2:
        nc *= 2
    return nc


def _setup(sa_pad: list[torch.Tensor], n_real: int):
    """phi and limit from the padded suffix array (pads at its head)."""
    g = local_iota(sa_pad)
    isa = dist_scatter_perm(g, sa_pad)
    phi = dist_gather(sa_pad, smap(lambda i: i - 1, isa), fill=-1)
    limits = [None] * len(sa_pad)
    for me in local_ids(sa_pad):
        # A predecessor that is a pad suffix or missing gives plcp 0
        # (only the real SA's head lands here).
        ok = (phi[me] >= 0) & (phi[me] < n_real) & (g[me] < n_real)
        phi[me] = torch.where(ok, phi[me], -1)
        limits[me] = torch.where(
            ok, n_real - torch.maximum(g[me], phi[me]), 0).to(torch.int32)
    return phi, limits


def _extend(texts, cur, phi, active, g, n_real: int, nc: int):
    """Bytes matched past ``cur`` (0..CMP_WIDTH) for each active position,
    by chunked text-window ring gathers."""
    n_shards = len(texts)
    mine = local_ids(texts)
    m = first_local(cur).shape[0]
    chunk = m // nc
    offs = torch.arange(CMP_WIDTH, dtype=torch.int32,
                        device=first_local(texts).device)[None, :]
    matched = smap(torch.empty_like, cur)
    for c in range(nc):
        part = slice(c * chunk, (c + 1) * chunk)
        a_pos, b_pos = [None] * n_shards, [None] * n_shards
        for me in mine:
            o = offs.to(texts[me].device)
            base = cur[me][part, None] + o
            a_pos[me] = (g[me][part, None] + base).reshape(-1)
            b_pos[me] = (phi[me][part, None] + base).reshape(-1)
        ta = dist_gather(texts, a_pos)
        tb = dist_gather(texts, b_pos)
        for me in mine:
            eq = ((ta[me] == tb[me]) & (a_pos[me] < n_real)
                  & (b_pos[me] < n_real) & (b_pos[me] >= 0)
                  ).view(chunk, CMP_WIDTH) & active[me][part, None]
            matched[me][part] = torch.cumprod(
                eq.to(torch.int32), 1, dtype=torch.int32).sum(
                    1, dtype=torch.int32)
    return matched


def _round(texts, phi, limit, n_real: int, nc: int, cur, resolved):
    """One distributed propagate + jump + extend round; returns (cur,
    resolved, unresolved count per shard)."""
    mine = local_ids(cur)
    g = local_iota(cur)

    # 1) monotone propagation: plcp[i] + i is non-decreasing.
    runs = smap(lambda c, gi: torch.cummax(c + gi, 0).values, cur, g)
    maxima = all_gather(smap(lambda r: r[-1], runs))            # (P,)
    for me in mine:
        before = maxima[me][:me]
        carry = before.max() if me else torch.tensor(
            INT32_FLOOR, dtype=torch.int32, device=runs[me].device)
        runmax = torch.maximum(runs[me], carry)
        prop = torch.minimum(
            torch.maximum(cur[me], runmax - g[me]).clamp_(min=0), limit[me])
        cur[me] = torch.where(resolved[me], cur[me], prop)
        resolved[me] = resolved[me] | (cur[me] >= limit[me])
    del runs

    # 2) pointer jumping along the aligned phi chain (one 3-column gather).
    for _ in range(JUMP_STEPS):
        tgt = smap(torch.add, g, cur)
        cols = smap(lambda p, c, r: torch.stack([p, c, r.to(torch.int32)],
                                                dim=1), phi, cur, resolved)
        got = dist_gather(cols, tgt, fill=-1)
        for me in mine:
            t_phi, t_cur, t_res = got[me].unbind(1)
            aligned = ((~resolved[me]) & (tgt[me] < n_real)
                       & (t_phi == phi[me] + cur[me]))
            bumped = torch.minimum(cur[me] + t_cur.clamp(min=0), limit[me])
            now_exact = aligned & (t_res == 1)
            cur[me] = torch.where(aligned, bumped, cur[me])
            resolved[me] = (resolved[me] | now_exact
                            | ((~resolved[me]) & (cur[me] >= limit[me])))
        del cols, got

    # 3) verified extension.
    active = smap(torch.logical_not, resolved)
    matched = _extend(texts, cur, phi, active, g, n_real, nc)
    for me in mine:
        cur[me] = cur[me] + torch.where(active[me], matched[me], 0)
        resolved[me] = resolved[me] | (active[me] & (matched[me] < CMP_WIDTH))
    unresolved = psum(smap(lambda r: (~r).sum(dtype=torch.int32), resolved))
    return cur, resolved, unresolved


def build_lcp_array_sharded(text, sa, mesh: Mesh | None = None,
                            info: dict | None = None) -> torch.Tensor:
    """LCP array int32[n] (lcp[0] = 0, lcp[i] = LCP of suffixes sa[i-1]
    and sa[i]) of ``text`` and its suffix array ``sa`` (int32[n], host or
    tensor), built block-sharded over ``mesh`` and returned whole on the
    mesh's first device (on every process of a mesh over several, each
    of which passes the whole text and SA).

    Positions are padded as the sharded builder pads them: the pad
    suffixes occupy the head of the padded SA in descending position
    order, so real SA neighbours stay adjacent. ``info``: optional dict
    that receives ``plcp_rounds``.

    Above ``SA_LCP_BIG_MIN`` (8 MiB) and below 2^31 - 1, a text whose
    residue is feasible at ``P * RESIDUE_SLOTS / 4`` takes the LCP of a
    carried-keys rebuild instead (the SA is unique, so ``sa`` is not
    read); a refusal comes back here."""
    mesh = make_mesh() if mesh is None else mesh
    n = text_length(text)
    dev0 = mesh.devices[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev0)
    if lcp_big_min() < n < (1 << 31) - 1:
        from hpc_suffix_array_tpu_torch.core.bigsort import residue_feasible
        from hpc_suffix_array_tpu_torch.core.residue import RESIDUE_SLOTS
        from hpc_suffix_array_tpu_torch.parallel.bigsort import (
            build_suffix_array_sharded_big)

        # The per-shard residue caps scale with the mesh size.
        if residue_feasible(as_byte_array(text), n,
                            mesh.size * RESIDUE_SLOTS / 4):
            try:
                return build_suffix_array_sharded_big(text, mesh,
                                                      want_lcp=True)[1]
            except NotImplementedError:
                pass                 # degenerate: PLCP handles any skew
    n_pad = padded_length(n, mesh.size)
    nc = chunk_count(n_pad // mesh.size)
    texts = padded_shards(text, n_pad, mesh)
    sa_pad = torch.cat([
        torch.arange(n_pad - 1, n - 1, -1, dtype=torch.int32, device=dev0),
        torch.as_tensor(sa).to(device=dev0, dtype=torch.int32)])
    sas = shard(sa_pad, mesh)
    del sa_pad

    phi, limit = _setup(sas, n)
    cur = smap(torch.zeros_like, phi)
    resolved = smap(lambda p: p < 0, phi)
    rounds = 0
    for _ in range(n // CMP_WIDTH + 2):
        cur, resolved, unresolved = _round(texts, phi, limit, n, nc, cur,
                                           resolved)
        rounds += 1
        if read_scalar(first_local(unresolved)) == 0:   # one host read
            break
    if info is not None:
        info["plcp_rounds"] = rounds
    # plcp (padded, position order) -> lcp in SA order; the real LCP
    # array is the tail, with lcp[0] = 0.
    lcp = unshard(dist_gather(cur, sas))[n_pad - n:]
    lcp[0] = 0
    return lcp
