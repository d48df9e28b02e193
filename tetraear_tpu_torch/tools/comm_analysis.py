"""Communication audit of the sharded receive steps (the port's twin of
tools/comm_analysis.py).

The JAX tool compiles each sharded step on an 8-device mesh and reads
every collective out of the optimized HLO.  The port has no HLO: each
rank runs its step, and the mesh counts every collective call as an HLO
collective instruction states it (parallel/halo.py): a halo side or a
carry is one `collective-permute` of its payload's shape, a psum one
`all-reduce`, a gather one `all-gather` of the gathered shape.  Each
call counts by its shape whether or not a peer takes part, so every
rank of a mesh counts the same, and a row compares kind for kind with
the JAX tool's (permute_bytes, allreduce_bytes,
other_collective_bytes).  Beside that: `sent_bytes`, what each rank of
the mesh put on the wire (by rank), and `result_gather_bytes`, the
gather of the global result (`sharded.gather_result`), which JAX's step
does not have (its runtime assembles the global array).

The steps are the JAX tool's three: `fused`, `realpair` and `etsi`, on
its per-shard block (scale x 1040 x decim x sps samples; the real-pair
and etsi steps round it up to their grids), its grid-aligned offsets
((k - C // 2) x 25 kHz, one carrier a carrier rank) and its halos, with
input noise made from seed 0.  The meshes are the factorizations of
--devices N ranks, (N, 1) .. (1, N): (8, 1), (4, 2), (2, 4), (1, 8) by
default, as in the JAX tool.

`t_compute_s` is the step's own time on its device at (1, 1) on the
same per-shard block (CUDA events around 5 steps, then a digest
pulled to the host; on the CPU the host clock), not a roofline; the
tool has no cost analysis, so `flops_per_device` and
`hbm_bytes_per_device` are null.  The link bandwidth is measured where
the world spans two cards or more (nccl send / recv between ranks 0 and
1, at each size the model reads: a halo payload, the all-reduce
payload and one rank's result block), or given with
--link-gbps; with neither, `t_comm_s`, the ratio and both efficiencies
are null and `link_source` is "unmeasured".  The model is the JAX
tool's: t_comm = permute / link(halo) + 2 x all-reduce / link(all-reduce)
+ all-gather / link(block), efficiency t_compute / (t_compute + t_comm)
without overlap and t_compute / max(t_compute, t_comm) with it.

* `--virtual N`: N gloo ranks on the CPU, spawned by `entry.launch`.
* Otherwise one rank per visible card over nccl (`--device cuda`, the
  default; without a card the tool exits naming --device cpu), or one
  rank on the CPU with `--device cpu`.
* Under a launcher (torchrun) or in a process whose world is already
  started, the tool runs in that world and rank 0 prints.

Every row (one JSON line per mesh and step) names the backend and the
device, a card as nvidia-smi gives its name and power limit.

    python -m tetraear_tpu_torch.tools.comm_analysis [--virtual N]
        [--devices N] [--scale S] [--link-gbps G] [--markdown PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np

STEPS = ("fused", "realpair", "etsi")
ITERS = 5                                # steps timed for t_compute_s
KINDS = ("collective-permute", "all-reduce", "all-gather")
FIELDS = {"fused": "sync_corr", "realpair": "sync_corr",
          "etsi": "soft_bits"}           # the digest of each step's result
SAME_ON_EVERY_RANK = ("collective_bytes", "collectives",
                      "result_gather_bytes")


def meshes(n: int) -> list:
    """The (carrier, time) factorizations of n ranks, time growing."""
    return [(n // t, t) for t in range(1, n + 1) if n % t == 0]


def step_case(step: str, carrier: int, time_: int, scale: int) -> tuple:
    """(per-shard samples, the halo, x (time x per-shard,) complex64,
    offsets (carrier,) float32) of `step` as the JAX tool sizes them."""
    from tetraear_tpu_torch.config import ReceiverConfig
    cfg = ReceiverConfig()
    step_len = cfg.decimation_factor * cfg.ref_samples_per_symbol
    t_local = scale * 1040 * step_len
    halo = 132 * step_len
    if step == "realpair":
        align = step_len * 96 // math.gcd(step_len, 96)
        t_local = -(-t_local // align) * align
        halo = -(-halo // align) * align       # the step's default
    elif step == "etsi":
        align = cfg.decimation_factor * 10 * cfg.etsi_sps
        t_local = -(-t_local // align) * align
        halo = 2 * align
    elif step != "fused":
        raise ValueError(f"step {step!r}: one of {STEPS}")
    rng = np.random.default_rng(0)
    n = time_ * t_local
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
         ).astype(np.complex64)
    offsets = ((np.arange(carrier) - carrier // 2) * 25e3).astype(np.float32)
    return t_local, halo, x, offsets


def build(mesh, step: str, halo: int, x, offsets, device) -> tuple:
    """(this rank's step, its local inputs) on `mesh`."""
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.parallel import sharded as sh
    cfg = ReceiverConfig()
    if step == "fused":
        run = sh.build_sharded_step_fused(mesh, offsets, cfg, halo=halo,
                                          device=device)
        return run, sh.shard_inputs(mesh, x, offsets, device)[:1]
    if step == "realpair":
        run, halo = sh.build_sharded_step_realpair(mesh, cfg, halo=halo,
                                                   device=device)
        return run, sh.realpair_shard_inputs(
            mesh, x, offsets, halo, cfg.sample_rate_hz, device=device)
    run, _ = sh.build_sharded_step_etsi(mesh, cfg, halo=halo, device=device)
    return run, sh.shard_inputs(mesh, x, offsets, device)


def _clear(mesh) -> None:
    for counter in (mesh.collective_bytes, mesh.collective_calls,
                    mesh.sent_bytes):
        counter.clear()


def count_step(mesh, run, args: tuple) -> dict:
    """One step and the gather of its result on this rank of `mesh`: the
    step's collectives by kind and by shape, the bytes this rank sent,
    and the result gather's bytes."""
    from tetraear_tpu_torch.parallel.sharded import gather_result
    _clear(mesh)
    out = run(*args)
    counts = {"collective_bytes": {k: mesh.collective_bytes[k]
                                   for k in KINDS},
              "collectives": dict(sorted(mesh.collective_calls.items())),
              "sent_bytes": sum(mesh.sent_bytes.values())}
    _clear(mesh)
    gather_result(mesh, out)
    counts["result_gather_bytes"] = mesh.collective_bytes["all-gather"]
    _clear(mesh)
    return counts


def step_seconds(run, args: tuple, field: str, device, iters: int) -> float:
    """Seconds per step of run(*args) on its device: a warm-up step, then
    `iters` steps between two CUDA events (the host clock on the CPU),
    the last result's digest pulled to the host."""
    import torch

    def digest(out) -> float:
        return float(getattr(out, field).abs().sum())

    digest(run(*args))
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = run(*args)
        end.record()
        digest(out)
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(*args)
    digest(out)
    return (time.perf_counter() - t0) / iters


def link_rate(nbytes: int, device, iters: int = 50,
              warmup: int = 5) -> float | None:
    """Bytes/s of one send of `nbytes` between ranks 0 and 1: `warmup`
    round trips, then `iters` between two synchronizations on the host
    clock; on rank 0 (None on rank 1).  Only ranks 0 and 1 call it."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    buf = torch.zeros(max(1, nbytes), dtype=torch.uint8, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def round_trips(n):
        for _ in range(n):
            if rank == 0:
                dist.send(buf, 1)
                dist.recv(buf, 1)
            else:
                dist.recv(buf, 0)
                dist.send(buf, 0)

    round_trips(warmup)
    sync()
    t0 = time.perf_counter()
    round_trips(iters)
    sync()
    dt = time.perf_counter() - t0
    return 2 * iters * buf.numel() / dt if rank == 0 else None


def device_name(device) -> str:
    """A card as nvidia-smi gives its name and power limit; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index}"],
                         capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {smi.returncode}: "
                           f"{smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _spans_cards(device_type: str) -> bool:
    """Ranks 0 and 1 of the world sit on two cards (one nccl rank a
    card, as `entry.rank_device` places them)."""
    import torch
    import torch.distributed as dist
    return (device_type == "cuda" and dist.get_backend() == "nccl"
            and dist.get_world_size() >= 2
            and torch.cuda.device_count() >= 2)


def _efficiency(row: dict, rate) -> None:
    """The JAX tool's model on a link of `rate` {kind: bytes/s} (None:
    unmeasured), with t_compute_s as the compute time."""
    if rate is None:
        row.update(t_comm_s=None, comm_compute_ratio=None,
                   eff_no_overlap=None, eff_overlap=None,
                   samples_per_sec_per_device_roofline_bound=None)
        return
    t_comp = row["t_compute_s"]
    t_comm = (row["permute_bytes"] / rate["collective-permute"]
              + 2 * row["allreduce_bytes"] / rate["all-reduce"]
              + row["other_collective_bytes"] / rate["all-gather"])
    row.update(t_comm_s=t_comm, comm_compute_ratio=t_comm / t_comp,
               eff_no_overlap=t_comp / (t_comp + t_comm),
               eff_overlap=t_comp / max(t_comp, t_comm),
               samples_per_sec_per_device_roofline_bound=(
                   row["per_shard_samples"] / (t_comp + t_comm)))


def run_world(device_type: str, devices: int, scale: int,
              link_gbps=None) -> list:
    """Every rank of a started world: the (1, 1) compute times, then each
    mesh of `devices` ranks and each step.  Returns the rows on rank 0
    ([] on the others)."""
    import torch.distributed as dist
    from tetraear_tpu_torch.entry import rank_device
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices > world:
        raise ValueError(f"--devices {devices} needs {devices} ranks; the "
                         f"world has {world} (--virtual N starts N gloo "
                         "ranks on the CPU)")
    device = rank_device(device_type, rank)

    # each step's own time at (1, 1), on rank 0, the others waiting
    mesh11 = make_mesh(1, 1, device_type=device_type)
    t_compute = {}
    if rank == 0:
        for step in STEPS:
            _, halo, x, offsets = step_case(step, 1, 1, scale)
            run, args = build(mesh11, step, halo, x, offsets, device)
            t_compute[step] = step_seconds(run, args, FIELDS[step], device,
                                           ITERS)
    dist.barrier()

    rows = []
    for carrier, time_ in meshes(devices):
        mesh = make_mesh(carrier, time_, device_type=device_type)
        if mesh.coords is None:
            continue
        for step in STEPS:
            t_local, halo, x, offsets = step_case(step, carrier, time_,
                                                  scale)
            run, args = build(mesh, step, halo, x, offsets, device)
            counts = count_step(mesh, run, args)
            every = [None] * (carrier * time_)
            dist.all_gather_object(every, counts, group=mesh.group)
            if rank != 0:
                continue
            for r, c in enumerate(every):
                if any(c[k] != counts[k] for k in SAME_ON_EVERY_RANK):
                    raise RuntimeError(f"{step} on ({carrier}, {time_}): "
                                       f"rank {r} counts {c}, rank 0 "
                                       f"{counts}")
            by_kind = counts["collective_bytes"]
            rows.append({
                "variant": step, "mesh": f"{carrier}x{time_}",
                "per_shard_samples": t_local,
                "collectives": counts["collectives"],
                "permute_bytes": by_kind["collective-permute"],
                "allreduce_bytes": by_kind["all-reduce"],
                "other_collective_bytes": by_kind["all-gather"],
                "flops_per_device": None, "hbm_bytes_per_device": None,
                "t_compute_s": t_compute[step],
                "sent_bytes": [c["sent_bytes"] for c in every],
                "result_gather_bytes": counts["result_gather_bytes"],
                "backend": dist.get_backend(),
                "device": device_name(device)})

    # the link: given, measured between two cards, or unmeasured
    rates = {}
    if link_gbps is not None:
        source = "given (--link-gbps)"
    elif _spans_cards(device_type):
        source = "measured (nccl send/recv between ranks 0 and 1)"
        sizes = [sorted({n for r in rows for n in _link_sizes(r).values()})]
        dist.broadcast_object_list(sizes, src=0)
        if rank < 2:
            rates = {n: link_rate(n, device) for n in sizes[0]}
    else:
        source = "unmeasured"
    dist.barrier()
    for row in rows:
        row["link_source"] = source
        sizes = _link_sizes(row)
        if link_gbps is not None:
            rate = dict.fromkeys(sizes, link_gbps * 1e9)
        elif rates:
            rate = {k: rates[n] for k, n in sizes.items()}
        else:
            rate = None
        row["link_bytes_per_s"] = rate
        _efficiency(row, rate)
    return rows


def _link_sizes(row: dict) -> dict:
    """The buffer sizes whose link rates a row's model reads, by kind: a
    halo payload and the all-reduce payload (the mean of the step's
    calls of the kind; 1 without one) and one rank's result block."""
    def payload(kind: str, nbytes: int) -> int:
        calls = sum(n for k, n in row["collectives"].items()
                    if k.startswith(kind + " "))
        return max(1, nbytes // calls) if calls else 1
    return {"collective-permute": payload("collective-permute",
                                          row["permute_bytes"]),
            "all-reduce": payload("all-reduce", row["allreduce_bytes"]),
            "all-gather": max(1, row["result_gather_bytes"]
                              // len(row["sent_bytes"]))}


def write_markdown(rows: list, path: Path) -> None:
    """The audit's table, headed by the device (a card's name and power
    limit)."""
    devices = sorted({r["device"] for r in rows})
    lines = [
        "# Communication audit of the sharded receive steps",
        "",
        f"Device: {', '.join(devices)}; backend "
        f"{', '.join(sorted({r['backend'] for r in rows}))}.  Written by "
        "`python -m tetraear_tpu_torch.tools.comm_analysis` (its "
        "docstring states the method).  Bytes are per rank and per step, "
        "counted as HLO collective instructions state them; t_compute is "
        "the step's own time at (1, 1) on the same per-shard block; the "
        "link is " + ", ".join(sorted({r["link_source"] for r in rows}))
        + ".",
        "",
        "| step | mesh C×T | shard samples | permute B | all-reduce B |"
        " all-gather B | result gather B | sent B (max rank) |"
        " t_compute ms | t_comm ms | eff (no overlap) | eff (overlap) |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]

    def opt(v, fmt):
        return "—" if v is None else format(v, fmt)

    for r in rows:
        lines.append(
            f"| {r['variant']} | {r['mesh']} | {r['per_shard_samples']:,}"
            f" | {r['permute_bytes']:,} | {r['allreduce_bytes']:,}"
            f" | {r['other_collective_bytes']:,}"
            f" | {r['result_gather_bytes']:,} | {max(r['sent_bytes']):,}"
            f" | {r['t_compute_s'] * 1e3:.3f}"
            f" | {opt(r['t_comm_s'] and r['t_comm_s'] * 1e3, '.4f')}"
            f" | {opt(r['eff_no_overlap'], '.4f')}"
            f" | {opt(r['eff_overlap'], '.4f')} |")
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.comm_analysis",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="N gloo ranks on the CPU")
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the meshes: every (C, T) with C x T = N "
                         "(default 8, the JAX tool's)")
    ap.add_argument("--scale", type=int, default=8,
                    help="per-shard block scale (8 = bench scale)")
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="link bandwidth per direction in GB/s (1e9 "
                         "bytes/s), for the efficiency fields where the "
                         "world does not span two cards")
    ap.add_argument("--markdown", type=str, default=None,
                    help="also write the table to this path")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the ranks without --virtual "
                         "(default cuda, one rank per card; without a card "
                         "the tool refuses to run unless given --device "
                         "cpu)")
    args = ap.parse_args(argv)

    import torch
    from tetraear_tpu_torch.entry import in_a_world, world_rows
    from tetraear_tpu_torch.ui.cli import _device

    device_type = "cpu" if args.virtual else _device(args.device).type
    n = args.virtual or (torch.cuda.device_count()
                         if device_type == "cuda" else 1)
    if args.devices > n and not in_a_world():
        ap.error(f"--devices {args.devices} needs {args.devices} ranks; "
                 f"this run has {n} (--virtual N starts N gloo ranks on "
                 "the CPU)")
    rows, _ = world_rows(run_world, device_type, n, {
        "devices": args.devices, "scale": args.scale,
        "link_gbps": args.link_gbps})
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.markdown and rows:
        write_markdown(rows, Path(args.markdown))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
