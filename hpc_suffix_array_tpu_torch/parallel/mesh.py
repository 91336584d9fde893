"""A mesh of shards, sharded arrays, and the collectives between them.

Counterpart of ``hpc_suffix_array_tpu/parallel/mesh.py`` plus the ``lax``
collectives its ``shard_map`` bodies call. The JAX package block-shards
every array along one sequence axis of a ``jax.sharding.Mesh``; here

  * a ``Mesh`` is P shards (a power of two: the compare-split sort
    network is a hypercube), shard i on ``devices[i % len(devices)]``,
    so P shards may share one card;
  * a **sharded array** is a Python list of P equal-length tensors, one
    per shard, in shard order (``shard`` and ``unshard`` go to and from a
    whole array);
  * the per-shard bodies of the modules in this package are plain
    functions of ``me`` (the shard index, ``lax.axis_index``) that run
    once per shard in a host loop;
  * the collectives below are the only place where data crosses shards,
    with ``lax``'s semantics: ``ppermute`` (a destination missing from
    ``perm`` gets zeros), ``all_gather``, ``psum``, ``pmax``, ``pmin``
    and ``all_to_all`` (``tiled=True`` on axis 0).

**Received tensors are read-only.** Where source and destination sit on
one device, ``ppermute`` hands over the source tensor itself (a ring
rotation then costs nothing on one card); across devices it copies. A
caller that writes in place into what it received (``radix_sort_words``
sorts in place, ``index_put_``) would corrupt the sender's shard, so
every caller in this package writes only into tensors it made.

``read_scalar`` is the one place where a sharded loop reads a device
value on the host (a round's convergence test); it counts its reads.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.device import resolve_device


class Mesh:
    """P shards over ``devices`` (shard i on ``devices[i % len]``)."""

    def __init__(self, n_shards: int, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(
                f"mesh size must be a power of two, got {n_shards}")
        self.size = int(n_shards)

    def device_of(self, i: int) -> torch.device:
        return self.devices[i % len(self.devices)]

    @property
    def shard_devices(self) -> list[torch.device]:
        return [self.device_of(i) for i in range(self.size)]

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards sit on."""
        return len({str(d) for d in self.shard_devices})

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {self.devices})"


def make_mesh(n_shards: int | None = None, devices=None,
              device="cuda") -> Mesh:
    """Mesh of ``n_shards`` shards.

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


def shard(x, mesh: Mesh) -> list[torch.Tensor]:
    """Sharded array of a whole array ``x`` (numpy or tensor) whose
    length is a multiple of the mesh size: fresh contiguous blocks, one
    on each shard's device."""
    t = torch.as_tensor(x)
    if t.shape[0] % mesh.size:
        raise ValueError(f"length {t.shape[0]} is not a multiple of the "
                         f"mesh size {mesh.size}")
    m = t.shape[0] // mesh.size
    return [t[i * m:(i + 1) * m].to(mesh.device_of(i), copy=True)
            for i in range(mesh.size)]


def unshard(xs: list[torch.Tensor], device=None) -> torch.Tensor:
    """The whole array of a sharded array, on ``device`` (default: shard
    0's device)."""
    dev = xs[0].device if device is None else torch.device(device)
    return torch.cat([x.to(dev) for x in xs])


def shard_iota(me: int, m: int, device) -> torch.Tensor:
    """Global positions int32[m] of shard ``me``'s block."""
    return torch.arange(me * m, (me + 1) * m, dtype=torch.int32,
                        device=device)


def ppermute(xs: list[torch.Tensor], perm) -> list[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) in ``perm``; a destination no pair names receives
    zeros. Received tensors are read-only (see the module doc)."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(xs[i]) if o is None else o
            for i, o in enumerate(out)]


def all_gather(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_gather``: every shard receives the stack of all shards'
    tensors (shape (P, ...))."""
    return [torch.stack([x.to(d.device) for x in xs]) for d in xs]


def _reduce(xs: list[torch.Tensor], op) -> list[torch.Tensor]:
    total = op(torch.stack([x.to(xs[0].device) for x in xs]), 0)
    return [total.to(x.device) for x in xs]


def psum(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.psum``: the elementwise sum over shards, on every shard."""
    return _reduce(xs, torch.sum)


def pmax(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.pmax``: the elementwise max over shards, on every shard."""
    return _reduce(xs, torch.amax)


def pmin(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.pmin``: the elementwise min over shards, on every shard."""
    return _reduce(xs, torch.amin)


def all_to_all(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)`` for x of shape
    (P, ...): shard ``me`` receives row ``me`` of every shard, stacked in
    shard order."""
    return [torch.stack([x[me].to(xs[me].device) for x in xs])
            for me in range(len(xs))]


def read_scalar(t: torch.Tensor):
    """Host value of a 0-d tensor (a Python number) or of a short 1-d
    tensor (a list): the one device-to-host read of a sharded loop's
    round, or of a build attempt's stats. Adds one to
    ``read_scalar.reads``."""
    read_scalar.reads += 1
    return t.tolist()


read_scalar.reads = 0
