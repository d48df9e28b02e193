"""The port's side of test_torch_parallel.py, run in the ranks of one
spawned 4-rank gloo world (tetraear_tpu_torch.entry.launch).

This module imports neither jax nor the JAX package, and each rank
refuses both with an import hook before it runs a case, so that the
ranks too are shown to need neither.  Rank 0 writes the gathered global
results to results.npz and the decoded frames to frames.json."""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REFUSED = ("jax", "jaxlib", "tetraear_tpu")


class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in REFUSED:
            raise ModuleNotFoundError(name + " is refused", name=name)
        return None


def _loaded_reference() -> list:
    return [m for m in sys.modules if m.partition(".")[0] in REFUSED]


def _frame_rows(frames) -> list:
    return [[f.tn, f.fn, f.mn, f.burst_kind, f.crc_ok, f.sds_message,
             None if f.sync_pdu is None else f.sync_pdu.mnc]
            for f in frames]


def run_cases(out_dir: str) -> None:
    """Every port-side case of the test file, in every rank."""
    if _loaded_reference():
        raise RuntimeError(f"reference modules loaded: {_loaded_reference()}")
    sys.meta_path.insert(0, RefuseReference())

    from tetraear_tpu_torch.parallel.halo import (carry_last, exchange_halo,
                                                  extend_with_halo,
                                                  gather_global)
    from tetraear_tpu_torch.parallel.mesh import make_mesh
    from tetraear_tpu_torch.parallel.sharded import (
        ShardedDownlinkReceiver, ShardedReceiver, build_sharded_step_fused,
        build_sharded_step_realpair, gather_result, realpair_shard_inputs,
        shard_inputs)

    out = Path(out_dir)
    inp = np.load(out / "inputs.npz")
    cpu = torch.device("cpu")
    res = {}

    # the halo primitives on a (1, 4) mesh
    mesh14 = make_mesh(1, 4, device_type="cpu")
    t = int(inp["halo_t"])
    idx = mesh14.index("time")
    xl = torch.as_tensor(inp["halo_x"][idx * t:(idx + 1) * t])
    lh, rh = exchange_halo(xl, 4, 4, mesh14)
    res["halo_exchange"] = gather_global(torch.cat([lh, rh])[None, None],
                                         mesh14)
    res["halo_extend"] = gather_global(
        extend_with_halo(xl, 4, 4, mesh14)[None, None], mesh14)
    res["halo_carry"] = gather_global(carry_last(xl, mesh14)[None, None],
                                      mesh14)

    # the staged, fused and real-pair steps and the stitching receivers
    # on a (2, 2) mesh
    mesh = make_mesh(2, 2, device_type="cpu")
    x, offsets = inp["x"], inp["offsets"]
    rx = ShardedReceiver(mesh, device=cpu)
    staged = rx(x, offsets)
    res.update({f"staged_{k}": v for k, v in staged._asdict().items()})
    frames = rx.decode(staged, len(x) // 2)
    xs, _ = shard_inputs(mesh, x, offsets, cpu)
    fused = gather_result(mesh, build_sharded_step_fused(
        mesh, offsets, device=cpu)(xs))
    res.update({f"fused_{k}": v for k, v in fused._asdict().items()})

    run_rp, halo_rp = build_sharded_step_realpair(mesh, device=cpu)
    rp = gather_result(mesh, run_rp(*realpair_shard_inputs(
        mesh, inp["x_rp"], offsets, halo_rp, 2.4e6, device=cpu)))
    res.update({f"realpair_{k}": v for k, v in rp._asdict().items()})

    # the etsi step and the downlink receiver on the two-cell capture
    x2, offs2 = inp["x_cells"], inp["offsets_cells"]
    dl = ShardedDownlinkReceiver(mesh, num_carriers=2, device=cpu)
    etsi = dl(x2, offs2)
    res["etsi_best_phase"] = etsi.best_phase
    res["etsi_stitched"] = torch.as_tensor(dl.stitch(etsi, len(x2) // 2))
    cells = [_frame_rows(f) for f in dl.receive(x2, offs2)]

    if _loaded_reference():
        raise RuntimeError(f"reference modules loaded: {_loaded_reference()}")
    if dist.get_rank() == 0:
        np.savez(out / "results.npz",
                 **{k: v.numpy() for k, v in res.items()})
        rows = [[{k: f.get(k) for k in ("number", "timeslot",
                                         "sync_position", "carrier",
                                         "time_shard", "sds_message")}
                 for f in fc] for fc in frames]
        (out / "frames.json").write_text(json.dumps(
            {"staged": rows, "cells": cells, "halo_rp": halo_rp}))


def fail_on_rank_1() -> None:
    """A rank that raises after the world is up; the others wait in a
    collective that never completes."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


def link_probe(out_dir: str) -> None:
    """tools/comm_analysis.link_rate between ranks 0 and 1 of a 2-rank
    world; rank 0 writes its rate to rate.json."""
    if _loaded_reference():
        raise RuntimeError(f"reference modules loaded: {_loaded_reference()}")
    sys.meta_path.insert(0, RefuseReference())
    from tetraear_tpu_torch.tools.comm_analysis import link_rate
    rate = link_rate(4096, torch.device("cpu"), iters=3, warmup=1)
    if dist.get_rank() == 0:
        (Path(out_dir) / "rate.json").write_text(json.dumps(rate))
    elif rate is not None:
        raise RuntimeError(f"rank 1 returned a rate: {rate}")
