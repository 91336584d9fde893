"""Multi-process execution: process-group init and the global mesh.

Counterpart of ``hpc_suffix_array_tpu/parallel/multihost.py``. The JAX
package starts one process per host with ``jax.distributed.initialize``
and builds its mesh over every device of the job; here

  * ``initialize_distributed`` joins ``torch.distributed``'s default
    process group through a store at the coordinator (``host:port``, a
    TCP store served by process 0, or any ``init_method`` URL such as
    ``file:///path``). The backend is NCCL when the shards sit on a card
    and gloo on the CPU; ``SA_PG_BACKEND=gloo`` asks for gloo with card
    tensors, every crossing staged through host memory, which is how
    several processes share one card (NCCL refuses two ranks on one
    device). The choice is printed and never switched after an error;
  * ``make_global_mesh`` gives process r of k the shards ``[r*dpp,
    (r+1)*dpp)`` of a ``k*dpp``-shard mesh, all on ``cuda:{r mod the
    card count}`` (or the CPU);
  * ``host_local_shard`` is the block of a padded text those shards
    own, and ``put_sharded_text`` places it.

The collectives of ``parallel/mesh.py`` cross processes over the default
group whenever a sharded array holds None for other processes' shards.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.parallel.mesh import Mesh, shard

BACKENDS = ("nccl", "gloo")


def pg_backend(device) -> str:
    """The process group's backend: ``SA_PG_BACKEND`` when set ("nccl" or
    "gloo"), else NCCL for a CUDA device and gloo for the CPU."""
    name = os.environ.get("SA_PG_BACKEND")
    if name is None:
        return "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if name not in BACKENDS:
        raise ValueError(f"SA_PG_BACKEND={name!r}: expected one of "
                         f"{BACKENDS}")
    return name


def process_device(device, process_id: int) -> torch.device:
    """The device of process ``process_id``: ``cuda:{id mod the card
    count}`` for a bare "cuda", else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda") -> None:
    """Join the process group (idempotent; a no-op for one process with
    no coordinator, as in the JAX package).

    ``coordinator_address``: ``host:port`` (a TCP store that process 0
    serves) or an ``init_method`` URL (``tcp://...``, ``file://...``).
    ``device``: where this process's shards live; it picks the backend
    (``pg_backend``) and, on a card, the current CUDA device."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and "
                         "process_id with a coordinator")
    backend = pg_backend(device)
    dev = process_device(device, process_id)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    extra = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            extra["device_id"] = dev
    print(f"process group: backend {backend}, process {process_id} of "
          f"{num_processes}, shards on {dev}", flush=True)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            **extra)


def make_global_mesh(devices_per_process: int = 1, device="cuda") -> Mesh:
    """The mesh of every shard of the job: process r of k holds shards
    ``[r*dpp, (r+1)*dpp)`` of ``k*dpp``, on ``process_device(device,
    r)``. Without a process group it is this process's ``dpp`` shards."""
    if dist.is_initialized():
        rank, count = dist.get_rank(), dist.get_world_size()
        group = dist.group.WORLD
    else:
        rank, count, group = 0, 1, None
    return Mesh(count * devices_per_process, [process_device(device, rank)],
                process_index=rank, process_count=count, group=group)


def host_local_shard(n_pad: int, mesh: Mesh) -> tuple[int, int]:
    """[start, stop) of the padded text block this process's shards own
    (shard i owns rows [i*m, (i+1)*m), m = n_pad / P)."""
    m = n_pad // mesh.size
    ids = mesh.local_ids
    return ids[0] * m, (ids[-1] + 1) * m


def put_sharded_text(text_pad: np.ndarray, mesh: Mesh) -> list:
    """The sharded array of a padded text (uint8[n_pad], n_pad a multiple
    of the mesh size): this process's shards placed, None for the
    others'."""
    arr = np.asarray(text_pad)
    if arr.dtype != np.uint8:
        raise ValueError(f"text_pad must be uint8, got {arr.dtype}")
    return shard(arr, mesh)
