"""The comparison that decides `correct`, run through the harness on the
CPU at a small size: the reference agrees with the port's `--device cpu`
path; the precision control and each fault the timed path can have, each
put in the program's place, come out not correct."""

import numpy as np
import pytest

from cellsize import tiny_cell

from benchmark import control, faults, harness, reference


def _run(cell, seed=2**31 + 3, factory=None, ring=None):
    result, _ = harness.run(cell, seed, 1.0, False, "cpu", 0.0,
                            system_factory=factory, ring=ring)
    return result


@pytest.mark.parametrize("name,busy", [("wb16.dense", 16), ("fb96.quiet", 4)])
def test_port_on_the_cpu_is_correct(name, busy):
    result = _run(tiny_cell(name, busy))
    check = result["check"]
    assert result["correct"], check
    assert check["stage_diff"]["value"] == 0
    assert check["frames_diff"]["value"] == 0
    assert result["info"]["slots_due"] > 0
    assert set(result["metrics"]) == {"iq_rate", "chunk_p95", "setup_s"}
    assert list(result)[-1] == "check"


def test_reference_bits_equal_the_port_on_busy_carriers():
    cell = tiny_cell("wb16.dense", 6)
    ring = cell.driver.make_ring(cell.config, cell.params, 17, "cpu")
    system = cell.driver.System(cell.config, "cpu")
    d = reference.design(cell.config)
    x = ring.chunks[1]
    prog = cell.driver.to_host(system.submit(x, 0))
    bits, count, _ = reference.demod(reference.channelize(x, d))
    for row in ring.busy:
        n = 2 * (int(prog["count"][row]) - 1)
        assert int(count[row]) == int(prog["count"][row])
        assert np.array_equal(bits[row, :n].numpy(), prog["bits"][row, :n])


@pytest.mark.parametrize("name,busy", [("wb16.dense", 16), ("fb96.quiet", 4)])
def test_precision_control_is_not_correct(name, busy):
    cell = tiny_cell(name, busy)
    for seed in (1, 2, 3):
        ring = cell.driver.make_ring(cell.config, cell.params, seed, "cpu")
        result = _run(cell, seed, control.factory(cell, "control", ring),
                      ring)
        check = result["check"]
        assert not result["correct"], check
        assert check["demod_gap"]["value"] > check["demod_gap"]["limit"]
        assert check["stage_diff"]["value"] == 0
        assert check["frames_diff"]["value"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name,busy", [("wb16.dense", 16), ("fb96.quiet", 4)])
def test_fault_is_not_correct(fault, name, busy):
    cell = tiny_cell(name, busy)
    seed = 2**31 + 3
    ring = cell.driver.make_ring(cell.config, cell.params, seed, "cpu")
    result = _run(cell, seed, control.factory(cell, fault, ring), ring)
    assert not result["correct"], result["check"]
