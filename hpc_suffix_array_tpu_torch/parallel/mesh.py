"""A mesh of shards, sharded arrays, and the collectives between them.

Counterpart of ``hpc_suffix_array_tpu/parallel/mesh.py`` plus the ``lax``
collectives its ``shard_map`` bodies call. The JAX package block-shards
every array along one sequence axis of a ``jax.sharding.Mesh``; here

  * a ``Mesh`` is P shards (a power of two: the compare-split sort
    network is a hypercube), shard i on ``devices[i % len(devices)]``,
    so P shards may share one card. A mesh over several processes
    (``parallel/multihost.py::make_global_mesh``) gives process r the
    shards ``[r*P/k, (r+1)*P/k)`` of its k processes (``local_ids``);
  * a **sharded array** is a Python list of P slots, one per shard, in
    shard order: a tensor for each shard this process holds and None
    for the shards of other processes, so a shard index ``me`` means
    the same shard on every process (``shard`` and ``unshard`` go to and
    from a whole array);
  * the per-shard bodies of the modules in this package are plain
    functions of ``me`` (the shard index, ``lax.axis_index``) that run
    once per local shard in a host loop (``local_ids``, ``smap``);
  * the collectives below are the only place where data crosses shards,
    with ``lax``'s semantics: ``ppermute`` (a destination missing from
    ``perm`` gets zeros), ``all_gather``, ``psum``, ``pmax``, ``pmin``
    and ``all_to_all`` (``tiled=True`` on axis 0).

A sharded array with a None slot spans processes: its collectives run
over the default ``torch.distributed`` process group (shard i lives in
process ``i // len(local_ids)``), in the same order on every process.
Pairs of shards on one process exchange as before; across processes
``ppermute`` is ``batch_isend_irecv``, ``all_gather`` an all-gather of
each process's local stack, the reductions a local reduce then
``all_reduce``, and ``all_to_all`` one ``all_to_all_single``. Under the
gloo backend, which carries host tensors, every crossing is staged
through host memory (the span "gloo host stage"). Every
process must call the same collectives in the same order, so a host
branch may only read values that are the same on every process: a
reduced scalar, never a shard's own.

**Received tensors are read-only.** Where source and destination sit on
one device, ``ppermute`` hands over the source tensor itself (a ring
rotation then costs nothing on one card); across devices it copies, and
across processes it receives into a fresh tensor. A caller that writes
in place into what it received (``radix_sort_words`` sorts in place,
``index_put_``) would corrupt the sender's shard, so every caller in
this package writes only into tensors it made.

``read_scalar`` is the one place where a sharded loop reads a device
value on the host (a round's convergence test); it counts its reads,
one per process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.utils.profiling import span


class Mesh:
    """P shards over ``devices`` (shard i on ``devices[i % len]``), of
    which process ``process_index`` of ``process_count`` holds the
    contiguous block ``local_ids``."""

    def __init__(self, n_shards: int, devices, process_index: int = 0,
                 process_count: int = 1, group=None):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(
                f"mesh size must be a power of two, got {n_shards}")
        if process_count < 1 or n_shards % process_count:
            raise ValueError(f"{n_shards} shards do not split evenly over "
                             f"{process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process index {process_index} is not in "
                             f"[0, {process_count})")
        self.size = int(n_shards)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.group = group

    @property
    def local_ids(self) -> list[int]:
        """The global indices of the shards this process holds."""
        per = self.size // self.process_count
        return list(range(self.process_index * per,
                          (self.process_index + 1) * per))

    def device_of(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    @property
    def shard_devices(self) -> list[torch.device]:
        return [self.device_of(i) for i in range(self.size)]

    @property
    def n_cards(self) -> int:
        """Distinct devices this process's shards sit on."""
        return len({str(self.device_of(i)) for i in self.local_ids})

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({self.size} shards on {self.devices}{procs})"


def make_mesh(n_shards: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """Mesh of ``n_shards`` shards, all in this process.

    ``devices``: an explicit list; shard i sits on ``devices[i %
    len(devices)]``. Default: one shard per visible card for ``device``
    "cuda" (raises when CUDA is missing), or the one CPU for "cpu".
    ``n_shards`` defaults to ``len(devices)``."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    devices = list(devices)
    return Mesh(len(devices) if n_shards is None else n_shards, devices)


def bucket_size(n: int, multiple_of: int = 1) -> int:
    """``n`` rounded up to a step of 1/8 of its octave (and to a multiple
    of ``multiple_of``), as ``hpc_suffix_array_tpu/core/suffix_array.py::
    bucket_size`` pads: the sharded builders pad to the same length, so
    their round counts match the JAX package's."""
    n = max(n, 1)
    step = max(1 << max(int(n - 1).bit_length() - 3, 0), multiple_of)
    return -(-n // step) * step


def padded_length(n: int, n_shards: int) -> int:
    """Padded text length of a P-shard build: ``bucket_size(n, P*128)``.
    Positions, ranks and the padded SA are int32, so it must stay below
    2^31; raises ValueError otherwise."""
    n_pad = bucket_size(n, multiple_of=n_shards * 128)
    if n_pad >= 1 << 31:
        raise ValueError(f"n={n} pads to {n_pad} positions on {n_shards} "
                         "shards; the sharded builders hold positions as "
                         "int32 and need fewer than 2^31")
    return n_pad


def local_ids(xs: list) -> list[int]:
    """Indices of the slots of a sharded array that this process holds."""
    return [i for i, x in enumerate(xs) if x is not None]


def first_local(xs: list) -> torch.Tensor:
    """The first tensor this process holds: the value of a replicated
    result (a reduction's output is the same on every shard)."""
    return next(x for x in xs if x is not None)


def smap(fn, *cols: list) -> list:
    """``fn`` over the local slots of sharded arrays of one mesh: slot i
    of the result is ``fn(cols[0][i], cols[1][i], ...)``, None where
    this process does not hold shard i."""
    return [None if args[0] is None else fn(*args) for args in zip(*cols)]


def shard(x, mesh: Mesh) -> list[torch.Tensor | None]:
    """Sharded array of a whole array ``x`` (numpy or tensor) whose
    length is a multiple of the mesh size: fresh contiguous blocks, one
    on each local shard's device, None for other processes' shards."""
    t = torch.as_tensor(x)
    if t.shape[0] % mesh.size:
        raise ValueError(f"length {t.shape[0]} is not a multiple of the "
                         f"mesh size {mesh.size}")
    m = t.shape[0] // mesh.size
    out: list[torch.Tensor | None] = [None] * mesh.size
    for i in mesh.local_ids:
        out[i] = t[i * m:(i + 1) * m].to(mesh.device_of(i), copy=True)
    return out


def shard_iota(me: int, m: int, device) -> torch.Tensor:
    """Global positions int32[m] of shard ``me``'s block."""
    return torch.arange(me * m, (me + 1) * m, dtype=torch.int32,
                        device=device)


def local_iota(xs: list) -> list:
    """``shard_iota`` of each local shard of the sharded array ``xs``
    (its length and device), None elsewhere."""
    return [None if x is None else shard_iota(me, x.shape[0], x.device)
            for me, x in enumerate(xs)]


# --- crossing processes -----------------------------------------------------

def _spans_processes(xs: list) -> bool:
    return any(x is None for x in xs)


def _layout(xs: list) -> tuple[list[int], int, int]:
    """(local ids, shards per process, process count) of a sharded
    array that spans processes; shard i lives in process i // per."""
    loc = local_ids(xs)
    per = len(loc)
    return loc, per, len(xs) // per


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective carries: ``t`` itself, or a host copy of a
    card tensor under gloo (which carries host tensors)."""
    t = t.contiguous()
    if t.device.type != "cpu" and dist.get_backend() == "gloo":
        with span("gloo host stage"):
            return t.cpu()
    return t


def _wire_empty(like: torch.Tensor, shape=None) -> torch.Tensor:
    """An uninitialised receive buffer for ``like``'s dtype, on the
    device the backend carries."""
    dev = like.device
    if dev.type != "cpu" and dist.get_backend() == "gloo":
        dev = torch.device("cpu")
    return torch.empty(like.shape if shape is None else shape,
                       dtype=like.dtype, device=dev)


def _arrive(t: torch.Tensor, device) -> torch.Tensor:
    """A received tensor on ``device`` (the host-to-card leg of a gloo
    stage)."""
    if t.device != torch.device(device):
        with span("gloo host stage"):
            return t.to(device)
    return t


def ppermute(xs: list, perm) -> list:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) in ``perm``; a destination no pair names receives
    zeros. Received tensors are read-only (see the module doc)."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    if not _spans_processes(xs):
        for src, dst in perm:
            out[dst] = xs[src].to(xs[dst].device)
        return [torch.zeros_like(xs[i]) if o is None else o
                for i, o in enumerate(out)]
    loc, per, _ = _layout(xs)
    mine = set(loc)
    ops, recvs = [], []
    # Every process walks ``perm`` in the same order, so the k-th send
    # from process a to b meets b's k-th receive from a (NCCL matches in
    # order; gloo also matches the tag).
    for src, dst in perm:
        tag = src * len(xs) + dst
        if src in mine and dst in mine:
            out[dst] = xs[src].to(xs[dst].device)
        elif src in mine:
            ops.append(dist.P2POp(dist.isend, _wire(xs[src]), dst // per,
                                  tag=tag))
        elif dst in mine:
            buf = _wire_empty(xs[dst])
            ops.append(dist.P2POp(dist.irecv, buf, src // per, tag=tag))
            recvs.append((dst, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for dst, buf in recvs:
        out[dst] = _arrive(buf, xs[dst].device)
    return [torch.zeros_like(x) if o is None and x is not None else o
            for x, o in zip(xs, out)]


def all_gather(xs: list) -> list:
    """``lax.all_gather``: every shard receives the stack of all shards'
    tensors (shape (P, ...))."""
    if not _spans_processes(xs):
        return [torch.stack([x.to(d.device) for x in xs]) for d in xs]
    loc, per, n_proc = _layout(xs)
    dev = xs[loc[0]].device
    mine = _wire(torch.stack([xs[i].to(dev) for i in loc]))
    parts = [_wire_empty(mine) for _ in range(n_proc)]
    dist.all_gather(parts, mine)
    full = _arrive(torch.cat(parts), dev)
    return smap(lambda x: full.to(x.device), xs)


def _reduce(xs: list, op, dist_op) -> list:
    loc = local_ids(xs)
    dev = xs[loc[0]].device
    total = op(torch.stack([xs[i].to(dev) for i in loc]), 0)
    if _spans_processes(xs):
        wire = _wire(total)
        dist.all_reduce(wire, dist_op)
        total = _arrive(wire, dev)
    return smap(lambda x: total.to(x.device), xs)


def psum(xs: list) -> list:
    """``lax.psum``: the elementwise sum over shards, on every shard."""
    return _reduce(xs, torch.sum, dist.ReduceOp.SUM)


def pmax(xs: list) -> list:
    """``lax.pmax``: the elementwise max over shards, on every shard."""
    return _reduce(xs, torch.amax, dist.ReduceOp.MAX)


def pmin(xs: list) -> list:
    """``lax.pmin``: the elementwise min over shards, on every shard."""
    return _reduce(xs, torch.amin, dist.ReduceOp.MIN)


def all_to_all(xs: list) -> list:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)`` for x of shape
    (P, ...): shard ``me`` receives row ``me`` of every shard, stacked in
    shard order."""
    if not _spans_processes(xs):
        return [torch.stack([x[me].to(xs[me].device) for x in xs])
                for me in range(len(xs))]
    loc, per, n_proc = _layout(xs)
    dev = xs[loc[0]].device
    rest = xs[loc[0]].shape[1:]
    # send[q, s, d] = row (q*per + d) of local shard s: process q's block.
    send = torch.stack([xs[s].to(dev) for s in loc]).reshape(
        per, n_proc, per, *rest).transpose(0, 1)
    send = _wire(send)
    recv = _wire_empty(send)
    dist.all_to_all_single(recv, send)
    # recv[q, s, d] = row (me*per + d) of process q's shard s.
    recv = _arrive(recv, dev)
    out: list[torch.Tensor | None] = [None] * len(xs)
    for j, d in enumerate(loc):
        out[d] = recv[:, :, j].reshape(len(xs), *rest).to(xs[d].device)
    return out


def unshard(xs: list, device=None) -> torch.Tensor:
    """The whole array of a sharded array, on ``device`` (default: the
    first local shard's device). Across processes every process receives
    it (an all-gather); shards may differ in length."""
    loc = local_ids(xs)
    dev = xs[loc[0]].device if device is None else torch.device(device)
    mine = torch.cat([xs[i].to(dev) for i in loc])
    if not _spans_processes(xs):
        return mine
    _, _, n_proc = _layout(xs)
    lens = [_wire_empty(torch.zeros(1, dtype=torch.int64, device=dev))
            for _ in range(n_proc)]
    dist.all_gather(lens, _wire(torch.tensor([mine.shape[0]], device=dev)))
    lens = [int(n) for n in torch.cat(lens).tolist()]
    top = max(lens)
    pad = torch.zeros((top - mine.shape[0],) + mine.shape[1:],
                      dtype=mine.dtype, device=dev)
    mine = _wire(torch.cat([mine, pad]))
    parts = [_wire_empty(mine) for _ in range(n_proc)]
    dist.all_gather(parts, mine)
    return _arrive(torch.cat([p[:k] for p, k in zip(parts, lens)]), dev)


def read_scalar(t: torch.Tensor):
    """Host value of a 0-d tensor (a Python number) or of a short 1-d
    tensor (a list): the one device-to-host read of a sharded loop's
    round, or of a build attempt's stats. The value must be replicated
    (the same on every process), since every process branches on it.
    Adds one to ``read_scalar.reads``."""
    read_scalar.reads += 1
    return t.tolist()


read_scalar.reads = 0
