"""Weak-scaling benchmark of the sharded receive step (the port's copy of
tools/bench_scaling.py; BASELINE config 5: >= 0.9 efficiency from one
card to N).

Runs the sharded step (parallel/sharded.py) on meshes of growing size
with constant work per rank and prints one JSON row per mesh: samples/s
(carrier-stream samples: the block's samples x carriers) and the
efficiency against the one-rank rate.  The mesh of n ranks is ranks
0 .. n-1 of one world: a time axis of 2 beyond one rank, carriers
n / 2, one carrier per carrier rank; the world's other ranks wait.

* `--virtual N`: N gloo ranks on the CPU, spawned by `entry.launch`.
  As in the JAX tool this is the correctness mode: its rates are the
  host's.
* Otherwise one rank per visible card over nccl (`--device cuda`, the
  default; without a card the tool exits naming --device cpu), or one
  rank on the CPU with `--device cpu`.
* Under a launcher (torchrun sets RANK and WORLD_SIZE), or in a process
  whose world is already started, the tool runs in that world, one rank
  per process, and rank 0 prints.

--profile ref runs the staged step (K5 on a card, channel FIR, demod),
--profile etsi the etsi step (K5, the 3/10 resampler, soft demod).  A
step's time: one warm-up step, then --iters steps between two barriers
of the mesh's ranks, each rank waiting for its device by pulling a
digest of its last result (the sum of |sync_corr| or |soft_bits|) to the
host.  --overhead also times the same whole block on a (1, 1) mesh (rank
0) and prints T_(1,1) / T_mesh.

    python -m tetraear_tpu_torch.tools.bench_scaling [--virtual N]
        [--per-device-samples S] [--iters N] [--profile ref|etsi]
        [--overhead] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

SIZES = (1, 2, 4, 8, 16, 32)
REF_HALO = 132 * 130              # the staged step's halo (samples)
ETSI_HALO = 4 * 400               # the etsi step's halo


def mesh_shape(n: int) -> tuple[int, int]:
    """(carrier, time) of the n-rank mesh: time 2 beyond one rank."""
    time_axis = 1 if n == 1 else 2
    return n // time_axis, time_axis


def block_inputs(n_dev: int, per_device_samples: int, profile: str):
    """Yields (n, (carrier, time), x, offsets) per mesh size up to n_dev:
    complex noise of 0.1 over time x the per-rank block (a multiple of
    400 on the etsi profile) and one carrier offset per carrier rank,
    drawn as the JAX tool draws them (one generator seeded 0, in size
    order)."""
    from tetraear_tpu_torch.config import ReceiverConfig
    cfg = ReceiverConfig()
    rng = np.random.default_rng(0)
    for n in (s for s in SIZES if s <= n_dev):
        carrier, time_axis = mesh_shape(n)
        t_local = per_device_samples
        if profile == "etsi":
            align = cfg.decimation_factor * 10 * cfg.etsi_sps     # 400
            t_local = max(align, (t_local // align) * align)
        total = time_axis * t_local
        x = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
             ).astype(np.complex64) * 0.1
        offsets = ((np.arange(carrier) * 25e3) - 25e3 * carrier / 2
                   ).astype(np.float32)
        yield n, (carrier, time_axis), x, offsets


def build_step(mesh, profile: str, device) -> tuple:
    """(this rank's step, the result field its digest reads)."""
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.parallel.sharded import (build_sharded_step,
                                                     build_sharded_step_etsi)
    cfg = ReceiverConfig()
    if profile == "etsi":
        run, _ = build_sharded_step_etsi(mesh, cfg, halo=ETSI_HALO,
                                         device=device)
        return run, "soft_bits"
    return (build_sharded_step(mesh, cfg, halo=REF_HALO, device=device),
            "sync_corr")


def timed(run, inputs: tuple, field: str, iters: int, mesh) -> tuple:
    """(seconds per step, the last result) of run(*inputs) on every rank
    of `mesh`: a warm-up step, then `iters` steps between two barriers
    of the mesh, each rank pulling a digest of its result to the host."""
    import torch.distributed as dist

    def digest(out) -> float:
        return float(getattr(out, field).abs().sum())

    out = run(*inputs)
    digest(out)
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(*inputs)
    digest(out)
    dist.barrier(group=mesh.group)
    return (time.perf_counter() - t0) / iters, out


def run_world(device_type: str, per_device_samples: int, iters: int,
              profile: str, overhead: bool, outputs=None) -> list:
    """Every rank of a started world: one mesh per size up to the world's.
    Returns the rows on rank 0 ([] on the others).  With `outputs` (a
    directory), rank 0 also saves each mesh's gathered global result
    there as <n>.npz."""
    import torch.distributed as dist
    from tetraear_tpu_torch.entry import rank_device
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    from tetraear_tpu_torch.parallel.sharded import (gather_result,
                                                     shard_inputs)
    rank = dist.get_rank()
    device = rank_device(device_type, rank)
    rows, rates = [], {}
    for n, (carrier, time_axis), x, offsets in block_inputs(
            dist.get_world_size(), per_device_samples, profile):
        # every rank of the world makes every mesh (new process groups)
        mesh = make_mesh(carrier, time_axis, device_type=device_type)
        mesh1 = (make_mesh(1, 1, device_type=device_type)
                 if overhead and n > 1 else None)
        if mesh.coords is None:
            continue
        run, field = build_step(mesh, profile, device)
        dt, out = timed(run, shard_inputs(mesh, x, offsets, device), field,
                        iters, mesh)
        if outputs is not None:
            res = gather_result(mesh, out)
            if rank == 0:
                np.savez(Path(outputs) / f"{n}.npz",
                         **{k: v.cpu().numpy()
                            for k, v in res._asdict().items()})
        if rank != 0:
            continue
        sps = x.shape[-1] * carrier / dt        # carrier-stream samples/s
        rates[n] = sps
        base = rates[SIZES[0]] * n / SIZES[0]
        rec = {"devices": n, "mesh": [carrier, time_axis],
               "samples_per_sec": round(sps, 1),
               "weak_scaling_efficiency": round(sps / base if base else 0.0,
                                                3)}
        if mesh1 is not None:
            # the same whole block on one rank: the ratio strips the
            # oversubscription of ranks that share cores or a card
            run1, _ = build_step(mesh1, profile, device)
            dt1, _ = timed(run1, shard_inputs(mesh1, x, offsets, device),
                           field, iters, mesh1)
            rec["sharding_overhead_efficiency"] = round(dt1 / dt, 3)
        rows.append(rec)
    return rows


def main(argv=None, *, outputs=None) -> int:
    """The tool on argv.  outputs: a directory where rank 0 also saves
    each mesh's gathered global result as <n>.npz (run_world)."""
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.tools.bench_scaling")
    ap.add_argument("--virtual", type=int, default=0,
                    help="N gloo ranks on the CPU (correctness mode)")
    ap.add_argument("--per-device-samples", type=int, default=1040 * 130)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--profile", choices=["ref", "etsi"], default="ref",
                    help="ref = the staged sharded step; etsi = the "
                         "rational-resampler soft-demod step "
                         "(build_sharded_step_etsi)")
    ap.add_argument("--overhead", action="store_true",
                    help="also time the same whole block on a (1, 1) mesh "
                         "and print sharding_overhead_efficiency = "
                         "T_(1,1) / T_mesh: on ranks that share cores or a "
                         "card, weak-scaling wall clock is bounded by the "
                         "sharing whatever the program; this ratio isolates "
                         "what sharding itself costs (halos, collectives)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the ranks without --virtual "
                         "(default cuda, one rank per card; without a card "
                         "the tool refuses to run unless given --device "
                         "cpu)")
    args = ap.parse_args(argv)

    import torch
    from tetraear_tpu_torch.entry import world_rows
    from tetraear_tpu_torch.ui.cli import _device

    device_type = "cpu" if args.virtual else _device(args.device).type
    opts = {"per_device_samples": args.per_device_samples,
            "iters": args.iters, "profile": args.profile,
            "overhead": args.overhead, "outputs": outputs}
    n = args.virtual or (torch.cuda.device_count()
                         if device_type == "cuda" else 1)
    rows, n_dev = world_rows(run_world, device_type, n, opts)
    if rows:                                    # rank 0
        print(f"# backend={device_type} devices={n_dev}", flush=True)
    for rec in rows:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
