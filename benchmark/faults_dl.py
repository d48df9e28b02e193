"""Readings for the limits of `correct` in the downlink cell, on the card:
benchmark/control.py's runner with the downlink's systems in the
program's place.

    python3 benchmark/faults_dl.py --workload dl.multiframe --seeds 1,2 \
        --systems program,control,bf16,flip_soft,colour,half_slots

Systems: `program`; `control`, the reference with its demod's filtered
signal in float8 e4m3; `bf16`, the reference's demod in float64 and its
Viterbi's path metrics in bfloat16; and the faults of FAULTS in
drivers/downlink.py.  Options and output are control.py's.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def factory(cell, system: str, ring):
    """A system_factory for harness.run: None for the program itself."""
    driver = cell.driver
    if system == "program":
        return None
    if system == "control":
        return lambda cfg, device: driver.Control(cfg, device, ring)
    if system == "bf16":
        return lambda cfg, device: driver.Control(
            cfg, device, ring, signal_dtype=None,
            metric_dtype=torch.bfloat16)
    return lambda cfg, device: driver.Faulty(driver.System(cfg, device),
                                             system)


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import control
    control.factory = factory
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
