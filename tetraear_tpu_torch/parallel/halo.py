"""Overlap-save halo exchange and the time axis's collectives.

The time axis shards one continuous sample stream; every convolutional
stage needs its neighbours' samples.  `exchange_halo` sends a block's
edges to the ranks before and after it along an axis with point-to-point
`isend` / `irecv` (`dist.batch_isend_irecv`, peers by global rank, as
torch.distributed takes them with `group=`).  The stream's edges are
zero-filled (the first shard's left halo, the last shard's right halo),
as the unsharded filters zero-pad; the edge ranks send nothing across
the ends of the stream, since what would arrive there is discarded.
`carry_last` passes each block's last element on to the next rank,
`psum` sums over an axis (`all_reduce`), `gather_global` collects every
rank's block of the mesh.  An axis of size 1 returns without
communicating.

Transport: an nccl world moves CUDA tensors as they are.  Gloo's
point-to-point and gather take host tensors only, so on a gloo world a
CUDA payload is copied to the host and back by `_to_wire` /
`_from_wire`, and the mesh counts those bytes (`Mesh.staged_bytes`).
The compute never leaves the device: only the exchanged edges, the
carried elements, the psum'd phase powers and the gathered results do.
Complex tensors travel as their real view.

Every collective is also counted on the mesh as an XLA program's
collective instruction would state it (`Mesh.collective_bytes`,
`collective_calls`, `sent_bytes`): a halo side or a carry is one
collective-permute of its payload's shape and dtype (a complex halo
counts as c64, the same bytes as its real view), sent or not; a psum is
one all-reduce, also over a group of one; a gather is one all-gather of
the gathered shape.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tetraear_tpu_torch.parallel.mesh import CARRIER_AXIS, TIME_AXIS, Mesh


_HLO_TYPES = {torch.complex64: "c64", torch.complex128: "c128",
              torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


def _count(mesh: Mesh, kind: str, x: torch.Tensor, shape: tuple,
           sent: int) -> None:
    """Count one collective of `kind` on a `shape` of x's dtype, of which
    this rank sends `sent` bytes."""
    dims = ",".join(map(str, shape))
    mesh.collective_bytes[kind] += math.prod(shape) * x.element_size()
    mesh.collective_calls[f"{kind} {_HLO_TYPES[x.dtype]}[{dims}]"] += 1
    mesh.sent_bytes[kind] += sent


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the collective takes it: a contiguous real tensor, on the
    host for a gloo world."""
    w = torch.view_as_real(x) if x.is_complex() else x
    if _staged(mesh, w):
        mesh.staged_bytes += w.numel() * w.element_size()
        w = w.cpu()
    return w.contiguous()


def _from_wire(mesh: Mesh, w: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
    """The inverse of _to_wire, onto `like`'s device and type."""
    if _staged(mesh, like):
        mesh.staged_bytes += w.numel() * w.element_size()
        w = w.to(like.device)
    return torch.view_as_complex(w) if like.is_complex() else w


def _wire_buffer(mesh: Mesh, like: torch.Tensor) -> torch.Tensor:
    """An empty receive buffer for what _to_wire(mesh, like) sends."""
    w = torch.view_as_real(like) if like.is_complex() else like
    return torch.empty(w.shape, dtype=w.dtype,
                       device="cpu" if _staged(mesh, like) else w.device)


def _neighbours(mesh: Mesh, axis: str, to_next, to_prev) -> tuple:
    """Send `to_next` to the next rank along `axis` and `to_prev` to the
    previous one (either may be None); returns (from the previous rank,
    from the next rank), None where the stream ends or nothing was
    sent."""
    n, idx = mesh.size(axis), mesh.index(axis)
    peers, group = mesh.ranks[axis], mesh.groups[axis]
    ops, got = [], [None, None]
    for k, (payload, dst, src) in enumerate(((to_next, idx + 1, idx - 1),
                                             (to_prev, idx - 1, idx + 1))):
        if payload is None:
            continue
        nbytes = payload.numel() * payload.element_size()
        _count(mesh, "collective-permute", payload, tuple(payload.shape),
               nbytes if 0 <= dst < n else 0)
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, _to_wire(mesh, payload),
                                  peers[dst], group))
        if 0 <= src < n:
            got[k] = _wire_buffer(mesh, payload)
            ops.append(dist.P2POp(dist.irecv, got[k], peers[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    like = (to_next, to_prev)
    return tuple(None if g is None else _from_wire(mesh, g, like[k])
                 for k, g in enumerate(got))


def exchange_halo(x: torch.Tensor, left: int, right: int, mesh: Mesh,
                  axis: str = TIME_AXIS) -> tuple:
    """(left_halo, right_halo) of this rank's block x (..., T): the last
    `left` samples of the previous rank's block (zeros on the first) and
    the first `right` samples of the next rank's (zeros on the last)."""
    left_halo = torch.zeros(x.shape[:-1] + (left,), dtype=x.dtype,
                            device=x.device)
    right_halo = torch.zeros(x.shape[:-1] + (right,), dtype=x.dtype,
                             device=x.device)
    if mesh.size(axis) == 1 or left + right == 0:
        return left_halo, right_halo
    from_prev, from_next = _neighbours(
        mesh, axis, x[..., x.shape[-1] - left:] if left else None,
        x[..., :right] if right else None)
    return (left_halo if from_prev is None else from_prev,
            right_halo if from_next is None else from_next)


def extend_with_halo(x: torch.Tensor, left: int, right: int, mesh: Mesh,
                     axis: str = TIME_AXIS) -> torch.Tensor:
    """The block with its neighbours' halos around it: (..., T+left+right)."""
    lh, rh = exchange_halo(x, left, right, mesh, axis)
    return torch.cat([lh, x, rh], dim=-1)


def carry_last(x: torch.Tensor, mesh: Mesh, fill=None,
               axis: str = TIME_AXIS) -> torch.Tensor:
    """Each block's last element (x[..., -1]) passed on to the next rank
    along the stream: the previous symbol of a differential demod.  The
    first rank receives `fill` (zeros by default)."""
    last = x[..., -1]
    if fill is None:
        first = torch.zeros_like(last)
    else:
        first = torch.as_tensor(fill, dtype=last.dtype,
                                device=last.device).expand(last.shape)
    if mesh.size(axis) == 1:
        return first.clone()
    from_prev, _ = _neighbours(mesh, axis, last, None)
    return first.clone() if from_prev is None else from_prev


def psum(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS) -> torch.Tensor:
    """The sum of x over the ranks of this rank's group along `axis`."""
    k = mesh.size(axis)
    nbytes = x.numel() * x.element_size()
    # a ring all-reduce puts 2 (k - 1) / k of the buffer on each rank's wire
    _count(mesh, "all-reduce", x, tuple(x.shape), 2 * (k - 1) * nbytes // k)
    if k == 1:
        return x
    wire = _to_wire(mesh, x).clone()
    dist.all_reduce(wire, group=mesh.groups[axis])
    return _from_wire(mesh, wire, x)


def gather_global(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block (C_local, 1, ...) of the mesh, assembled on
    every rank as the global (C, n_time, ...): rank c * n_time + t holds
    carriers [c C_local, (c + 1) C_local) of time block t."""
    n_c, n_t = mesh.size(CARRIER_AXIS), mesh.size(TIME_AXIS)
    _count(mesh, "all-gather", x, (n_c * x.shape[0], n_t, *x.shape[2:]),
           (n_c * n_t - 1) * x.numel() * x.element_size())
    wire = _to_wire(mesh, x)
    if n_c * n_t == 1:
        parts = [wire]
    else:
        parts = [torch.empty_like(wire) for _ in range(n_c * n_t)]
        dist.all_gather(parts, wire, group=mesh.group)
    g = torch.stack(parts).reshape(n_c, n_t, *wire.shape)
    g = g.select(3, 0).movedim(2, 1)                  # (n_c, C_l, n_t, ...)
    g = g.reshape(n_c * wire.shape[0], n_t, *wire.shape[2:])
    return _from_wire(mesh, g.contiguous(), x)
