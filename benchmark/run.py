"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload fb96.dense --seed 7 --seconds 50 \
        --trace 0

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`check`: each number compared with its limit, which also end standard
error.  Exits non-zero, printing no result, without a CUDA card, with
fewer cards than the cell asks for, or when jax, jaxlib, flax or the JAX
package tetraear_tpu were loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tetraear_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name, whole, is one of
    FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    cell = harness.Cell(args.workload)
    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded, and must not be: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in lines:
        print(f"{name} {value!r} limit {limit!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
