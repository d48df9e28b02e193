"""A cell's run loads neither JAX nor the JAX package, compared by whole
top-level names; the command refuses to run without a card; the `cuda`
tests run the command on the card."""

import json
import subprocess
import sys

import pytest

from cellsize import ROOT

RUN_TINY = """
import sys, time
t = time.monotonic()
sys.path[:0] = [{root!r}, {tests!r}]
from cellsize import tiny_cell
from benchmark import harness, run
result, _ = harness.run(tiny_cell("fb96.dense", 3), 5, 0.5, True, "cpu", t)
print(run.forbidden_modules())
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"tetraear_tpu", "tetraear_tpu_torch", "jax"}}))
"""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = RUN_TINY.format(root=str(ROOT),
                           tests=str(ROOT / "benchmark" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['tetraear_tpu_torch']"


def test_forbidden_names_are_compared_whole():
    from benchmark import run
    assert run.forbidden_modules(["tetraear_tpu_torch", "jaxtyping",
                                  "tetraear_tpu_torch.ops", "flaxy"]) == []
    assert run.forbidden_modules(["tetraear_tpu.ops.fir", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "tetraear_tpu"]


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wb16.quiet", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(card, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "wb16.quiet", "--seed", "4", "--seconds", "2",
                          "--trace", str(trace)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
