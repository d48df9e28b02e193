"""Readings for the limits of `correct`, on the card: on each seed, one
short run of the cell through `harness.run` (the timed loop, its sampled
chunks compared as in every run) with the program, the precision control
(the reference in the program's place, its operands in float8 e4m3) or a
planted fault (faults.py) in the system's place.

    python3 benchmark/control.py --workload fb96.dense --seeds 1,2,3 \
        --systems program,control,stale,half_rows

One JSON line per seed and system on standard output, with the card's
name, the numbers compared beside their limits and the verdict.  The
benchmark's own runs do not run this; limits are set between the
program's largest reading and the control's smallest (PERF.md).  Exits
non-zero, with no reading, without a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def factory(cell, system: str, ring):
    """A system_factory for harness.run: None for the program itself."""
    if system == "program":
        return None
    if system == "control":
        return lambda cfg, device: cell.driver.Control(cfg, device, ring)
    from benchmark import faults
    return lambda cfg, device: faults.Faulty(
        cell.driver.System(cfg, device), system, ring.busy)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--systems", default="program,control",
                   help="comma-separated: program, control, or a fault of "
                        "faults.FAULTS")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="each run's window")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark import harness
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(device)
    cell = harness.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ring = cell.driver.make_ring(cell.config, cell.params, seed, device)
        for system in args.systems.split(","):
            t0 = time.monotonic()
            result, _ = harness.run(cell, seed, args.seconds, False, device,
                                    t0, system_factory=factory(
                                        cell, system, ring), ring=ring)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "system": system,
                "device": kind, "correct": result["correct"],
                "check": result["check"], "info": result["info"],
                "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
