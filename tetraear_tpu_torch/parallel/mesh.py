"""The (carrier, time) rank layout of the pod-scale receive.

The workload's parallel axes:
  carrier  independent RF channels; they never communicate;
  time     one long sample stream cut into blocks, stitched with
           overlap-save halos sent between neighbouring blocks.

One rank runs one shard.  Rank r of the mesh sits at carrier index
r // time and time index r % time, so `carrier` is the outer dimension
and a time group is a run of consecutive ranks (on a multi-host world,
ranks of one host).  Each axis has one process group per line of the
mesh, made with `dist.new_group` by every rank of the world in the same
order; a third group holds all the mesh's ranks, for the gather of the
global result.  The mesh records the device type its tensors live on;
the compute device itself is the caller's, passed to the builders.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

CARRIER_AXIS = "carrier"
TIME_AXIS = "time"


class Mesh:
    """A (carrier, time) layout over the ranks 0 .. carrier * time - 1 of
    the initialized world, as seen from this rank.

    shape: {axis: size}.  coords: {axis: this rank's index}, or None on a
    rank of the world outside the mesh.  ranks: {axis: the global ranks
    of this rank's group along the axis, by index}.  groups: {axis: that
    group}; group: the mesh's ranks.  backend: the world's (gloo or nccl).
    staged_bytes counts the bytes that the collectives of a gloo mesh
    copy between a CUDA device and the host (gloo's point-to-point and
    gather take host tensors only).

    The collectives' volume, as an XLA program's collective instructions
    state it (parallel/halo.py counts; tools/comm_analysis.py reads):
    collective_bytes {kind: bytes}, kinds "collective-permute" (halo
    sides, carries), "all-reduce" (psum) and "all-gather" (the global
    gather), each call counted by its operand's shape (an all-gather's by
    its gathered result), whether or not a peer takes part, so that every
    rank of the mesh counts the same; collective_calls {"kind dtype[dims]":
    calls}, the same calls by shape; sent_bytes {kind: bytes this rank
    put on the wire} (nothing to a missing peer or a group of one)."""

    axis_names = (CARRIER_AXIS, TIME_AXIS)

    def __init__(self, carrier: int, time: int, device_type: str):
        rank = dist.get_rank()
        self.shape = {CARRIER_AXIS: carrier, TIME_AXIS: time}
        self.device_type = device_type
        self.backend = dist.get_backend()
        self.staged_bytes = 0
        self.collective_bytes = Counter()
        self.collective_calls = Counter()
        self.sent_bytes = Counter()
        self.group = dist.new_group(list(range(carrier * time)))
        self.coords = None
        self.ranks = {}
        self.groups = {}
        for c in range(carrier):
            line = [c * time + t for t in range(time)]
            g = dist.new_group(line)
            if rank in line:
                self.ranks[TIME_AXIS], self.groups[TIME_AXIS] = line, g
        for t in range(time):
            line = [c * time + t for c in range(carrier)]
            g = dist.new_group(line)
            if rank in line:
                self.ranks[CARRIER_AXIS], self.groups[CARRIER_AXIS] = line, g
        if rank < carrier * time:
            self.coords = {CARRIER_AXIS: rank // time, TIME_AXIS: rank % time}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside the "
                               f"{self.shape} mesh")
        return self.coords[axis]

    def __repr__(self) -> str:
        return (f"Mesh(carrier={self.shape[CARRIER_AXIS]}, "
                f"time={self.shape[TIME_AXIS]}, {self.device_type}, "
                f"{self.backend}, coords={self.coords})")


def make_mesh(carrier: Optional[int] = None, time: Optional[int] = None, *,
              device_type: str) -> Mesh:
    """Build a (carrier, time) mesh over the initialized world's ranks.

    With no sizes given, every rank goes to the carrier axis (carriers
    never communicate: prefer that axis where the carrier count allows).
    Every rank of the world must call it, with the same arguments.
    Raises without an initialized world (it never starts one:
    `distributed.initialize_distributed` does), for a CUDA mesh on a
    machine without a card, and for an NCCL world on CPU tensors."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized world: call "
                           "parallel.distributed.initialize_distributed "
                           "first")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type {device_type!r}: cpu or cuda")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA card; this machine "
                           "has none")
    if device_type == "cpu" and dist.get_backend() == "nccl":
        raise ValueError("an nccl world moves CUDA tensors only; start a "
                         "gloo world for a cpu mesh")
    n = dist.get_world_size()
    if carrier is None and time is None:
        carrier, time = n, 1
    elif carrier is None:
        if n % time:
            raise ValueError(f"{n} ranks do not split into time = {time}")
        carrier = n // time
    elif time is None:
        if n % carrier:
            raise ValueError(f"{n} ranks do not split into carrier = "
                             f"{carrier}")
        time = n // carrier
    if carrier < 1 or time < 1 or carrier * time > n:
        raise ValueError(f"a ({carrier}, {time}) mesh needs {carrier * time}"
                         f" ranks; the world has {n}")
    return Mesh(carrier, time, device_type)


def factor_mesh(n: int) -> tuple[int, int]:
    """Default (carrier, time) factorization for n ranks: prefer a 2-ish
    time axis so halo exchange paths are exercised."""
    if n == 1:
        return (1, 1)
    if n % 2 == 0:
        return (n // 2, 2)
    return (n, 1)
