"""The benchmark of tetraear_tpu_torch on an NVIDIA H100: `python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.

Everything one configuration, traffic mix, cell or metric needs sits in
files of its own, found by the names in BENCHMARK.json:
configs/<config>.json, traffic/<traffic>.json, cells/<cell>.json,
metrics/<metric>.py, kernels/<kernel>.py, and drivers/<driver>.py (named
by the configuration), which makes the cell's traffic from its traffic
file and drives the program.  control.py reads the limits of `correct`
on the card, with the precision control or a fault of faults.py in the
program's place.
"""
