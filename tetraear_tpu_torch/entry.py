"""Entry points of the port: a forward step and a multi-rank dry run.

``entry(device)`` returns the multi-carrier receive forward step (the
staged chain, K5 on a card, with the candidates stage) and example
arguments, for a one-device check.

``dryrun_multichip(n, device_type)`` starts n ranks of one world, builds
their (carrier, time) mesh and runs the four sharded receive steps
(parallel/sharded.py: staged, fused, etsi, real-pair) once each at tiny
shapes: overlap-save halo sends along time, the time-summed symbol
timing, the carrier-sharded channelizer.

``launch(n, device_type, target, *args)`` is the rank launcher both use:
n processes by the `spawn` start method, joined through a FileStore in
a temporary file; the first rank that fails ends the run in every rank
and raises here with its traceback.  ``world_rows`` runs a tool's
per-rank function in a started world or in launched ranks and returns
rank 0's rows (tools/bench_scaling.py, tools/comm_analysis.py).

    python -m tetraear_tpu_torch.entry --device cuda|cpu
    torchrun --nproc-per-node N -m tetraear_tpu_torch.entry --device cuda

Without a launcher, the module runs `entry` on the device and then
`dryrun_multichip` over spawned ranks: one a card on cuda, 4 on the
cpu.  Under torchrun every rank runs both in the launcher's
world, on cuda:LOCAL_RANK.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np


def entry(device):
    """-> (fn, example_args): the 4-carrier forward step on 66,560 samples
    of noise, fn(x) -> MulticarrierResult with 32 candidates a carrier."""
    import torch
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.models.multicarrier import (
        StagedMulticarrierFrontend)

    cfg = ReceiverConfig()
    num_carriers = 4
    n = 512 * cfg.decimation_factor * cfg.ref_samples_per_symbol  # 66560

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64) * 0.1
    offsets = ((np.arange(num_carriers) - (num_carriers - 1) / 2) * 25e3
               ).astype(np.float32)
    forward = StagedMulticarrierFrontend.from_offsets(
        offsets, cfg, device=device, num_candidates=32, threshold=0.80)
    return forward, (torch.as_tensor(x, device=device),)


class RankFailed(RuntimeError):
    """A rank of a launched world failed; the message holds its traceback."""


def _rank_main(rank: int, n: int, store: str, device_type: str,
               backend, errors, target, args) -> None:
    """A spawned rank: join the world, run target(*args), leave it."""
    import torch
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import initialize_distributed
    torch.set_num_threads(1)
    try:
        initialize_distributed(device_type, f"file://{store}", n, rank,
                               backend=backend)
        try:
            target(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise


def _drain(errors, reports: dict, timeout: float) -> None:
    """Move every (rank, traceback) the queue yields within `timeout` of
    each into `reports`."""
    try:
        while True:
            rank, tb = errors.get(timeout=timeout)
            reports[rank] = tb
    except queue.Empty:
        pass


def launch(n: int, device_type: str, target, *args, backend=None,
           timeout: float = 600.0) -> None:
    """Run target(*args) in n spawned ranks of one world (ranks 0..n-1,
    device_type's backend unless `backend` names one).  target is a
    module-level function; it reads its rank from torch.distributed.
    Returns when every rank has finished; raises RankFailed when one
    fails (the others are ended) or when `timeout` seconds pass."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    errors = ctx.Queue()
    fd, store = tempfile.mkstemp(prefix="tetraear-world-")
    os.close(fd)
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, store, device_type, backend, errors, target, args))
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode not in (None, 0)]
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if bad or alive:
            msg = (f"rank {bad[0][0]} exited {bad[0][1]}" if bad else
                   f"ranks {alive} still running after {timeout:.0f} s")
            # the other ranks' collectives fail in turn: collect every
            # report for a while, reading the queue before any join
            reports = {}
            until = time.monotonic() + 10
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < until):
                _drain(errors, reports, 0.2)
            _drain(errors, reports, 0.5)
            for rank in sorted(reports):
                msg += f"\nrank {rank} raised:\n{reports[rank]}"
            raise RankFailed(msg)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        errors.close()
        if os.path.exists(store):
            os.unlink(store)


def _rows_rank(fn, device_type: str, kwargs: dict, out_dir: str) -> None:
    """A launched rank of world_rows: rank 0's rows to out_dir/rows.json."""
    import torch.distributed as dist
    rows = fn(device_type, **kwargs)
    if dist.get_rank() == 0:
        (Path(out_dir) / "rows.json").write_text(json.dumps(rows))


def in_a_world() -> bool:
    """This process's world is started, or a launcher's environment
    names one."""
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import LAUNCHER_ENV
    return dist.is_initialized() or any(k in os.environ
                                        for k in LAUNCHER_ENV)


def world_rows(fn, device_type: str, n: int, kwargs: dict) -> tuple:
    """(rank 0's rows, the world's size) of fn(device_type, **kwargs), a
    module-level function that every rank of a world runs and that
    returns its rows on rank 0 ([] on the others).  Where this process's
    world is started, or a launcher's environment names one, fn runs in
    it (a world started here is destroyed after); else in n ranks
    spawned by `launch`, and this process gets rank 0's rows."""
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    if in_a_world():
        started_here = not dist.is_initialized()
        initialize_distributed(device_type)
        try:
            return fn(device_type, **kwargs), dist.get_world_size()
        finally:
            if started_here:
                dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        launch(n, device_type, _rows_rank, fn, device_type, kwargs, tmp)
        return json.loads((Path(tmp) / "rows.json").read_text()), n


def dryrun(mesh, device) -> None:
    """Run the four sharded steps once on `mesh` at tiny shapes, in every
    rank of an initialized world, and check the global results' shapes."""
    import math
    from tetraear_tpu_torch.config import ReceiverConfig
    from tetraear_tpu_torch.parallel.mesh import CARRIER_AXIS, TIME_AXIS
    from tetraear_tpu_torch.parallel.sharded import (
        build_sharded_step, build_sharded_step_etsi, build_sharded_step_fused,
        build_sharded_step_realpair, gather_result, realpair_shard_inputs,
        shard_inputs)

    carrier, time_ = mesh.size(CARRIER_AXIS), mesh.size(TIME_AXIS)
    cfg = ReceiverConfig()
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    t_local = 140 * step               # tiny per-shard block (> halo)
    total = time_ * t_local
    num_carriers = carrier             # one carrier per carrier shard

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
         ).astype(np.complex64) * 0.1
    offsets = ((np.arange(num_carriers) - (num_carriers - 1) / 2) * 25e3
               ).astype(np.float32)

    xs, offs = shard_inputs(mesh, x, offsets, device)
    run = build_sharded_step(mesh, cfg, device=device)
    out = gather_result(mesh, run(xs, offs))
    assert out.bits.shape[:2] == (num_carriers, time_), out.bits.shape

    # the fused-conv step (composite kernels sharded over carriers)
    out_f = gather_result(mesh, build_sharded_step_fused(
        mesh, offsets, cfg, device=device)(xs))
    assert out_f.bits.shape == out.bits.shape

    # the etsi step (rational resampler + soft demod)
    align = cfg.decimation_factor * 10 * cfg.etsi_sps       # 400
    t_local_e = 8 * align
    xe = (rng.standard_normal(time_ * t_local_e)
          + 1j * rng.standard_normal(time_ * t_local_e)
          ).astype(np.complex64) * 0.1
    run_e, _ = build_sharded_step_etsi(mesh, cfg, halo=2 * align,
                                       device=device)
    out_e = gather_result(mesh, run_e(*shard_inputs(mesh, xe, offsets,
                                                    device)))
    assert out_e.soft_bits.shape[:2] == (num_carriers, time_)

    # the real-pair step at a steady-state shape (shards well beyond the
    # halo), on grid-aligned (25 kHz-multiple) offsets for its mixer table
    offsets_rp = ((np.arange(num_carriers) - num_carriers // 2) * 25e3
                  ).astype(np.float32)
    run_rp, halo_rp = build_sharded_step_realpair(mesh, cfg, device=device)
    lcm = step * 96 // math.gcd(step, 96)
    t_local_rp = max(4 * halo_rp, -(-560 * step // lcm) * lcm)
    xr = (rng.standard_normal(time_ * t_local_rp)
          + 1j * rng.standard_normal(time_ * t_local_rp)
          ).astype(np.complex64) * 0.1
    out_r = gather_result(mesh, run_rp(*realpair_shard_inputs(
        mesh, xr, offsets_rp, halo_rp, cfg.sample_rate_hz, device=device)))
    assert out_r.bits.shape[:2] == (num_carriers, time_)


def rank_device(device_type: str, rank: int):
    """The device of `rank` in a launched world: the CPU, or card
    rank mod the card count (every rank on the one card of a one-card
    machine).  It is made the current CUDA device."""
    import torch
    if device_type == "cpu":
        return torch.device("cpu")
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _dryrun_rank(device_type: str) -> None:
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.mesh import factor_mesh, make_mesh
    device = rank_device(device_type, dist.get_rank())
    carrier, time_ = factor_mesh(dist.get_world_size())
    dryrun(make_mesh(carrier, time_, device_type=device_type), device)


def dryrun_multichip(n_devices: int, device_type: str) -> None:
    """Start n_devices ranks and run the four sharded steps on their
    factor_mesh(n) mesh at tiny shapes.  On cuda each rank takes card
    rank mod the card count, over nccl; more ranks than cards share
    cards over gloo (nccl takes one rank a card)."""
    backend = None
    if device_type == "cuda":
        import torch
        if n_devices > torch.cuda.device_count():
            backend = "gloo"
    launch(n_devices, device_type, _dryrun_rank, device_type,
           backend=backend)


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(prog="python -m tetraear_tpu_torch.entry",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("entry: no CUDA card here; pass --device cpu", file=sys.stderr)
        return 2
    if "RANK" in os.environ:                # under torchrun
        import torch.distributed as dist
        from tetraear_tpu_torch.parallel.distributed import (
            initialize_distributed)
        initialize_distributed(args.device)
        rank = dist.get_rank()
        device = rank_device(args.device,
                             int(os.environ.get("LOCAL_RANK", rank)))
        fn, fargs = entry(device)
        out = fn(*fargs)
        print(f"rank {rank}: entry() ran on {device}:",
              {k: tuple(v.shape) for k, v in out._asdict().items()})
        from tetraear_tpu_torch.parallel.distributed import make_global_mesh
        dryrun(make_global_mesh(args.device), device)
        print(f"rank {rank}: dryrun over {dist.get_world_size()} ranks OK")
        dist.destroy_process_group()
        return 0
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    fn, fargs = entry(device)
    out = fn(*fargs)
    print(f"entry() ran on {device}:",
          {k: tuple(v.shape) for k, v in out._asdict().items()})
    n = torch.cuda.device_count() if args.device == "cuda" else 4
    dryrun_multichip(n, args.device)
    print(f"dryrun_multichip({n}, {args.device!r}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
