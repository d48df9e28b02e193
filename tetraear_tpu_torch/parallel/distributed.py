"""Start-up of the world the pod-scale receive runs in.

TETRA carriers never communicate and time halos only touch neighbouring
blocks, so the pod recipe is:

  1. `initialize_distributed(device_type)` in every rank: from a
     launcher's environment (`torchrun`: RANK, WORLD_SIZE, MASTER_ADDR,
     MASTER_PORT), from an explicit rendezvous, or, with neither, a
     world of one rank;
  2. one (carrier, time) mesh over the world (`make_global_mesh`):
     `carrier` across hosts (no traffic), `time` over the ranks within a
     host, so that the halo sends stay on a host's own links;
  3. each rank takes its own block of the stream (`host_local_shard`,
     or `sharded.shard_inputs` from a whole capture) and runs the
     sharded step (parallel/sharded.py).

A failed start raises.  In particular, where a launcher's environment
is present and the process group does not come up, the rank does not go
on alone: it would decode its own block as if it were the whole stream.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from tetraear_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def initialize_distributed(device_type: str,
                           coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None) -> bool:
    """Start this rank's world; returns True when it has more than one
    rank.

    device_type: "cuda" (backend nccl) or "cpu" (gloo); `backend`
    overrides the choice (gloo for several ranks on one card, which nccl
    refuses).  coordinator_address: a rendezvous URL (tcp://host:port,
    file:///path) or host:port, with num_processes and process_id.
    Without it, a launcher's environment (RANK and WORLD_SIZE set) is
    read; with neither, a world of one rank starts through a FileStore
    in a temporary file.  A world already started is left as it is."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: cpu or cuda")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed('cuda') needs a CUDA "
                           "card; this machine has none")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    backend = backend or BACKENDS[device_type]
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif any(k in os.environ for k in LAUNCHER_ENV):
        dist.init_process_group(backend)
    else:
        fd, path = tempfile.mkstemp(prefix="tetraear-world-")
        os.close(fd)
        # the store deletes its file when the world is destroyed
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    logger.info("torch.distributed: rank %d of %d, backend %s",
                dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("no world: call initialize_distributed first")
    return dist.get_rank(), dist.get_world_size()


def host_local_shard(total_samples: int) -> tuple[int, int]:
    """(start, length) of this rank's slice of a time-sharded stream,
    aligned to the decimation x samples-per-symbol grid (130 at the
    reference rates) so the shard contracts hold."""
    grid = 130
    rank, world = _world()
    per = (total_samples // world // grid) * grid
    return rank * per, per


def make_global_mesh(device_type: str, time_axis_per_host: int = 1) -> Mesh:
    """(carrier, time) mesh over the whole world: the time axis spans
    time_axis_per_host x the ranks of one host (LOCAL_WORLD_SIZE, as a
    launcher sets it; 1 without), cut down to a divisor of the world;
    the carrier axis spans the rest."""
    _rank, n_total = _world()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    time_size = min(time_axis_per_host * max(n_local, 1), n_total)
    while n_total % time_size:
        time_size -= 1
    return make_mesh(n_total // time_size, time_size,
                     device_type=device_type)
