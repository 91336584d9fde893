"""Suffix-array construction by prefix doubling, in PyTorch.

Counterpart of ``hpc_suffix_array_tpu/core/suffix_array.py`` (the
Manber-Myers doubling builder): the same packed initial ranks, the same
``FACTOR = 2`` rounds of (sort, dense re-rank, route back) and the same
termination rule, so the round count matches the JAX kernel's on the
same initial ranks. The suffix array of a text is unique, so the output
equals the JAX package's and SA-IS's byte for byte.

Differences from the JAX version:
  * the ``lax.while_loop`` is a Python loop with one ``.item()`` sync
    per round (the converged test);
  * no padding to a bucketed length: that existed for XLA's compile
    cache. Pad positions add rounds, so ``rounds`` is comparable only
    against the JAX kernel fed the same unpadded initial ranks.

``build_suffix_array`` routes as the JAX package's does above
``SA_BIG_THRESHOLD`` (4 MiB), and above ``SA_CHAIN_MIN`` (4 MiB) for
texts of deep repeats: to the direct carried-keys builder
(``core/bigsort.py``, with device tie refinement) when ``prefer_direct``
holds, otherwise or when it declines to the MSD bucket builder (same
module), and when that declines to the doubling builder
(``build_suffix_array_doubling``) up to ``DOUBLING_REACH`` and to host
SA-IS (``sais_host_fallback``) above it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.kernels.pack import pack_ranks
from hpc_suffix_array_tpu_torch.ops.scan import dense_ranks, route_to_positions
from hpc_suffix_array_tpu_torch.ops.shift import shifted_ranks
from hpc_suffix_array_tpu_torch.ops.sort import sort_by_rank_pairs

# Prefix-multiplication factor per round: the reference doubles.
FACTOR = 2
# Bit budget for the packed initial rank code (must stay positive int32).
PACK_BITS = 30
# Largest text the doubling builder serves as a fallback. Doubling plus
# PLCP peaked at 69.06 GiB at 2^30 random alnum on an H100 80GB HBM3
# (30.00 GiB at 2^29; PERF.md); above it the routers close with host
# SA-IS. The JAX package's reach, 2^28, was set by TPU v5e memory.
DOUBLING_REACH = 1 << 30
# Text bytes per bincount call in the device presence pass: bounds the
# int64 temporary (8 B per byte) to 128 MiB.
PRESENCE_CHUNK = 1 << 24


def big_threshold() -> int:
    """Texts above this many bytes (``SA_BIG_THRESHOLD``, 4 MiB, a
    threshold set on a TPU) try the carried-keys builder first."""
    return int(os.environ.get("SA_BIG_THRESHOLD", 1 << 22))


def chain_min() -> int:
    """Texts above this many bytes (``SA_CHAIN_MIN``, 4 MiB, a threshold
    set on a TPU) but not above ``big_threshold()`` try the carried-keys
    builder when their repeats are deep (``deep_repeat_class``)."""
    return int(os.environ.get("SA_CHAIN_MIN", 1 << 22))


def doubling_reach() -> int:
    """Texts above this many bytes never take the doubling fallback."""
    return DOUBLING_REACH


def as_byte_array(text) -> np.ndarray:
    """Coerce str/bytes/array input to a uint8 numpy array (zero-copy where possible)."""
    if isinstance(text, torch.Tensor):
        return text.detach().cpu().numpy().astype(np.uint8, copy=False)
    if isinstance(text, str):
        text = text.encode("utf-8")
    if isinstance(text, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(text), dtype=np.uint8)
    arr = np.asarray(text)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


def as_byte_tensor(text, device) -> torch.Tensor:
    """uint8[n] tensor of ``text`` on ``device`` (no copy for a uint8
    tensor already there)."""
    dev = resolve_device(device)
    if isinstance(text, torch.Tensor):
        return text.to(device=dev, dtype=torch.uint8).contiguous()
    # torch.tensor copies, so read-only inputs (bytes, memmaps) are fine.
    return torch.tensor(as_byte_array(text), dtype=torch.uint8, device=dev)


def device_text(text, device, text_dev=None) -> torch.Tensor:
    """uint8[n] copy of ``text`` on ``device``: the first n bytes of
    ``text_dev`` when that is a uint8 tensor on the device holding at
    least n bytes (the caller's promise: the same bytes), else staged."""
    dev = resolve_device(device)
    n = (int(text.shape[0]) if isinstance(text, torch.Tensor)
         else len(as_byte_array(text)))
    if (isinstance(text_dev, torch.Tensor) and text_dev.dtype == torch.uint8
            and text_dev.device.type == dev.type
            and text_dev.shape[0] >= n):
        return text_dev[:n]
    return as_byte_tensor(text, dev)


def _doubling_round(rank: torch.Tensor, k: int):
    """One round: pair sort + dense re-rank (+ route back unless converged).

    Returns (new_rank, max_rank, sorted_idx). On the converged round
    (all ranks distinct) the route back to position order is skipped:
    new_rank is never read again."""
    n = rank.shape[0]
    sorted_key, s_idx = sort_by_rank_pairs(rank, shifted_ranks(rank, k))
    dense, max_rank_t = dense_ranks(sorted_key)
    del sorted_key
    max_rank = int(max_rank_t)          # the round's one host sync
    if max_rank >= n - 1:
        return rank, max_rank, s_idx
    return route_to_positions(s_idx, dense), max_rank, s_idx


def suffix_array_kernel(rank0: torch.Tensor, k0: int):
    """Suffix order for initial ranks ``rank0`` (int32[n], n >= 1) that
    cover the ``k0``-symbol prefix of each suffix.

    Returns (sa int32[n], rank int32[n], rounds int). ``rank`` is the
    dense rank as of the round before the converging one (diagnostics
    only, not the inverse SA), as in the JAX kernel."""
    n = rank0.shape[0]
    rank, k, max_rank, rounds = rank0, int(k0), -1, 0
    sa = None
    while rounds == 0 or (max_rank < n - 1 and k < 2 * n):
        rank, max_rank, sa = _doubling_round(rank, k)
        k *= FACTOR
        rounds += 1
    return sa.to(torch.int32), rank, rounds


def remap_from_present(present: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(remap int32[256], bits, h0) from a byte-presence mask.

    remap sends each present byte to its code in 1..K; each symbol takes
    bits = bit_length(K) bits and h0 = PACK_BITS // bits symbols pack
    into one int32 initial rank (DNA: h0 = 10; full bytes: h0 = 3)."""
    present = np.asarray(present, bool)
    remap = np.cumsum(present).astype(np.int32) * present
    k = max(int(remap.max()), 1)
    bits = max(1, int(k).bit_length())
    h0 = max(1, PACK_BITS // bits)
    return remap, bits, h0


def alphabet_remap(arr: np.ndarray) -> tuple[np.ndarray, int, int]:
    """``remap_from_present`` of a host text (one chunked bincount)."""
    counts = np.zeros(256, np.int64)
    for i in range(0, arr.size, PRESENCE_CHUNK):
        counts += np.bincount(arr[i:i + PRESENCE_CHUNK], minlength=256)
    return remap_from_present(counts > 0)


def alphabet_remap_dev(text: torch.Tensor) -> tuple[np.ndarray, int, int]:
    """``alphabet_remap`` of a uint8 tensor, counted on its device."""
    counts = torch.zeros(256, dtype=torch.int64, device=text.device)
    for i in range(0, text.shape[0], PRESENCE_CHUNK):
        counts += torch.bincount(text[i:i + PRESENCE_CHUNK].long(),
                                 minlength=256)
    return remap_from_present((counts > 0).cpu().numpy())


def pack_ranks_kernel(text: torch.Tensor, remap: np.ndarray, bits: int,
                      h0: int, n_real: int) -> torch.Tensor:
    """Packed initial ranks of a uint8 tensor (``kernels.pack``)."""
    remap_t = torch.as_tensor(remap, dtype=torch.int32).to(text.device)
    return pack_ranks(text, remap_t, bits, h0, n_real)


def build_suffix_array_doubling(text, *, device, info: dict | None = None
                                ) -> torch.Tensor:
    """Suffix array int32[n] by prefix doubling, at any n.

    ``info``: optional dict that receives ``path`` ("doubling") and
    ``rounds`` (doubling rounds run)."""
    t = as_byte_tensor(text, device)
    n = t.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=t.device)
    remap, bits, h0 = alphabet_remap_dev(t)
    rank0 = pack_ranks_kernel(t, remap, bits, h0, n)
    sa, _rank, rounds = suffix_array_kernel(rank0, h0)
    if info is not None:
        info["path"] = "doubling"
        info["rounds"] = rounds
    return sa


def sais_host_fallback(text, *, device, info: dict | None = None
                       ) -> torch.Tensor:
    """Last-resort builder: host SA-IS (native C, O(n)) for a text every
    device route declined, returned as int32[n] on ``device``.

    The direct builder with refinement resolves any bounded-depth tie
    structure, so this serves texts past the doubling fallback's reach
    whose ties exceed the refinement caps (e.g. one huge non-periodic
    repeated block). ``info`` receives ``path`` = "sais_host"."""
    from hpc_suffix_array_tpu_torch import native

    sa = torch.from_numpy(native.sa_build(as_byte_array(text)))
    if info is not None:
        info["path"] = "sais_host"
    return sa.to(resolve_device(device))


def carried_keys_build(arr: np.ndarray, n: int, t: torch.Tensor,
                       remap: np.ndarray, est: int, info: dict | None,
                       want_lcp: bool):
    """The carried-keys routes in the JAX package's order: the direct
    builder when ``prefer_direct`` holds, else (or when it declines) the
    MSD builder. Returns the SA (``(sa, lcp)`` with ``want_lcp``), or
    None when both decline; ``info`` receives the build's keys and
    ``path`` ("direct" or "msd"), or ``declined``."""
    from hpc_suffix_array_tpu_torch.core import bigsort

    kw = dict(device=t.device, info=info, want_lcp=want_lcp, text_dev=t,
              remap=remap, est_repeat=est)
    routes = [("msd", bigsort.build_suffix_array_big)]
    if bigsort.prefer_direct(arr, n, est_repeat=est, sigma=int(remap.max())):
        routes.insert(0, ("direct", bigsort.build_suffix_array_direct))
    for path, build in routes:
        try:
            out = build(arr, **kw)
        except NotImplementedError as e:
            if info is not None:
                info["declined"] = str(e)
            continue
        if info is not None:
            info["path"] = path
        return out
    return None


def build_suffix_array(text, *, device, info: dict | None = None,
                       text_dev: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Suffix array int32[n] of ``text`` (str, bytes, uint8 array or
    tensor), built on ``device``.

    ``text_dev``: optional uint8 copy of the same bytes on ``device``
    (see ``device_text``). Above ``SA_BIG_THRESHOLD``, and above
    ``SA_CHAIN_MIN`` for deep-repeat texts, the router plans
    on the host bytes, so pass ``text`` as a host array and the device
    copy here: a device tensor as ``text`` costs a copy to the host.

    ``info``: optional dict that receives ``path`` ("direct", "msd",
    "doubling" or "sais_host"), the carried-keys build's keys
    (``rerun``, ``chain_mode``, ``n_patched``, ``periods``, ``n_words``
    or ``n_buckets_run``, the ``refine_*`` keys), ``declined`` (why a
    carried-keys builder fell back) or ``rounds``."""
    t = device_text(text, device, text_dev)
    n = t.shape[0]
    if n > big_threshold() or n > chain_min():
        from hpc_suffix_array_tpu_torch.core import bigsort

        arr = as_byte_array(text)
        # One repeat scan (and alphabet count) feeds the gate and the
        # builder. Between the two thresholds only deep repeats, which
        # no one-pass window resolves, take the carried keys.
        est = bigsort.estimate_repeat_len(arr)
        if n > big_threshold() or bigsort.deep_repeat_class(est):
            remap, _, _ = alphabet_remap_dev(t)
            out = carried_keys_build(arr, n, t, remap, est, info,
                                     want_lcp=False)
            if out is not None:
                return out
    if n > doubling_reach():
        return sais_host_fallback(text, device=t.device, info=info)
    return build_suffix_array_doubling(t, device=t.device, info=info)


@dataclass
class SuffixArray:
    """Result object bundling text, SA and LCP (field names as in the
    JAX package; its ``mesh`` is not ported, ``device`` takes its place)."""

    text: np.ndarray                    # uint8[n]
    device: torch.device
    sa: torch.Tensor | None = None      # int32[n]
    lcp: torch.Tensor | None = None     # int32[n]
    timings: dict = field(default_factory=dict)

    @classmethod
    def create(cls, text, *, device) -> "SuffixArray":
        return cls(text=as_byte_array(text), device=resolve_device(device))

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    def build(self) -> "SuffixArray":
        self.sa = build_suffix_array(self.text, device=self.device)
        return self

    def build_lcp(self) -> "SuffixArray":
        from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array
        if self.sa is None:
            self.build()
        self.lcp = build_lcp_array(self.text, self.sa, device=self.device)
        return self

    def longest_repeated_substring(self):
        from hpc_suffix_array_tpu_torch.core.lrs import (
            find_longest_repeated_substring)
        if self.lcp is None:
            self.build_lcp()
        return find_longest_repeated_substring(self.text, self.sa, self.lcp,
                                               device=self.device)

    def validate(self) -> bool:
        from hpc_suffix_array_tpu_torch.core.validate import (
            is_valid_suffix_array)
        if self.sa is None:
            self.build()
        return is_valid_suffix_array(self.text, self.sa, device=self.device)
