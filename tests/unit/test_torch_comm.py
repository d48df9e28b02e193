"""The port's communication audit (tetraear_tpu_torch/tools/
comm_analysis.py) against the JAX tool's (tools/comm_analysis.py), on
the CPU.

The JAX tool's `analyze(carrier, time, variant, 1)` compiles each
sharded step in this process (the conftest's 8 virtual CPU devices) and
reads its collectives out of the optimized HLO; the port's tool runs
the same steps in a spawned world of 4 gloo ranks (`--virtual 4
--devices 4 --scale 1`) and counts each collective call on the mesh.
Held equal, kind for kind and shape for shape: the all-reduce (the
time-summed phase power) and the in-step all-gather (none in either).
The collective-permutes differ by one thing, pinned here from the
step's shapes: JAX's fused and real-pair steps also send the last
symbol of each block to the next time shard (`carry_last`, a c64[C_l],
or two f32[C_l] for the real pair) and then drop the one decision it
seeds; the port's steps do not send it, because the halo overlap
already gives every owned symbol its predecessor.  The halo permutes
themselves are equal.

Every test ends within its own deadline (SIGALRM)."""

import contextlib
import importlib.util
import io
import json
import re
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig as JaxReceiverConfig

from tetraear_tpu_torch import entry as tentry
from tetraear_tpu_torch.tools import comm_analysis as ca

import torch_parallel_ranks

REPO = Path(__file__).resolve().parents[2]
DEADLINE_S = 55
MESHES = [(4, 1), (2, 2), (1, 4)]
ARGV = ["--virtual", "4", "--devices", "4", "--scale", "1"]
LINK_GBPS = 10.0
# what JAX's step sends and the port's does not where time > 1: the
# carried symbol of its one carrier (call key -> calls; bytes)
JAX_ONLY_CARRY = {"fused": ({"collective-permute c64[1]": 1}, 8),
                  "realpair": ({"collective-permute f32[1]": 2}, 2 * 4),
                  "etsi": ({}, 0)}


@pytest.fixture(autouse=True)
def _deadline():
    """A deadline of its own for each test: SIGALRM raises in it."""
    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {DEADLINE_S} s deadline")
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tool_comm_analysis", REPO / "tools" / "comm_analysis.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = {}


def _jax_row(carrier: int, time_: int, step: str) -> dict:
    """The JAX tool's row, compiled once per (mesh, step)."""
    key = (carrier, time_, step)
    if key not in JAX:
        JAX[key] = _jax_tool().analyze(carrier, time_, step, 1)
    return JAX[key]


def _main(argv: list) -> list:
    """The port's rows printed by main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ca.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    """One spawned 4-rank gloo world: the rows of the three steps on the
    meshes of 4 ranks, with a given link rate, and the markdown table."""
    md = tmp_path_factory.mktemp("comm") / "audit.md"
    signal.alarm(120)
    try:
        rows = _main([*ARGV, "--link-gbps", str(LINK_GBPS),
                      "--markdown", str(md)])
    finally:
        signal.alarm(0)
    return {(r["variant"], r["mesh"]): r for r in rows}, md.read_text()


def _calls(row: dict) -> dict:
    """A row's collectives by "kind dtype[dims]" (HLO layouts cut)."""
    return {re.sub(r"\{[0-9,]*\}$", "", k): v
            for k, v in row["collectives"].items()}


def _halo_side_bytes(step: str) -> int:
    """One halo payload, from the step's shapes: H complex samples, or
    a (2, H) real pair."""
    _, halo, _, _ = ca.step_case(step, 1, 1, 1)
    return 8 * halo if step != "realpair" else 2 * 4 * halo


def _gathered_bytes(step: str, carrier: int, time_: int) -> int:
    """The global result's bytes from the step's shapes: bits (u8),
    sync scores (f32) and the best phase (s32), or the etsi LLRs (f32)
    and the best phase, over (C, n_time)."""
    cfg = JaxReceiverConfig()
    t_local, halo, _, _ = ca.step_case(step, carrier, time_, 1)
    dec = (t_local + 2 * halo) // cfg.decimation_factor
    if step == "etsi":
        m_ext = (dec * 3 // 10) // cfg.etsi_sps - 1
        per_shard = 4 * 2 * (m_ext - 1) + 4
    else:
        b_ext = 2 * (dec // cfg.ref_samples_per_symbol - 2)
        per_shard = b_ext + 4 * (b_ext - 21) + 4
    return carrier * time_ * per_shard


@pytest.mark.parametrize("carrier,time_", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("step", ca.STEPS)
def test_bytes_equal_jax_tool(audit, step, carrier, time_):
    got = audit[0][(step, f"{carrier}x{time_}")]
    want = _jax_row(carrier, time_, step)
    assert got["per_shard_samples"] == want["per_shard_samples"]
    assert got["allreduce_bytes"] == want["allreduce_bytes"] > 0
    assert got["other_collective_bytes"] == want["other_collective_bytes"]
    carry_calls, carry_bytes = JAX_ONLY_CARRY[step] if time_ > 1 else ({}, 0)
    assert got["permute_bytes"] + carry_bytes == want["permute_bytes"]
    calls = _calls(got)
    for key, n in carry_calls.items():
        calls[key] = calls.get(key, 0) + n
    assert calls == _calls(want)
    # what each rank of the mesh sent: its halo sides that have a peer
    # and its ring share of the all-reduce
    side = _halo_side_bytes(step)
    ring = 2 * (time_ - 1) * got["allreduce_bytes"] // time_
    want_sent = [side * ((t > 0) + (t < time_ - 1)) * (time_ > 1) + ring
                 for _ in range(carrier) for t in range(time_)]
    assert got["sent_bytes"] == want_sent
    assert got["result_gather_bytes"] == _gathered_bytes(step, carrier,
                                                         time_)


def test_rows_carry_the_jax_keys_and_the_ports(audit):
    jax_keys = set(_jax_row(2, 2, "etsi"))
    port_keys = {"backend", "device", "link_source", "sent_bytes",
                 "result_gather_bytes", "link_bytes_per_s"}
    rows = audit[0]
    assert sorted(rows) == sorted((s, f"{c}x{t}") for s in ca.STEPS
                                  for c, t in MESHES)
    for row in rows.values():
        assert set(row) == jax_keys | port_keys
        assert row["flops_per_device"] is None
        assert row["hbm_bytes_per_device"] is None
        assert (row["backend"], row["device"]) == ("gloo", "cpu")
        assert row["t_compute_s"] > 0


def test_efficiency_on_a_given_link(audit):
    """--link-gbps: the JAX tool's model on 1e9 x G bytes/s."""
    for row in audit[0].values():
        rate = LINK_GBPS * 1e9
        t_comm = (row["permute_bytes"] + 2 * row["allreduce_bytes"]
                  + row["other_collective_bytes"]) / rate
        t_comp = row["t_compute_s"]
        assert row["link_source"] == "given (--link-gbps)"
        assert row["link_bytes_per_s"] == dict.fromkeys(ca.KINDS, rate)
        assert row["t_comm_s"] == pytest.approx(t_comm, rel=1e-12)
        assert row["comm_compute_ratio"] == pytest.approx(t_comm / t_comp)
        assert row["eff_no_overlap"] == pytest.approx(
            t_comp / (t_comp + t_comm))
        assert row["eff_overlap"] == pytest.approx(
            t_comp / max(t_comp, t_comm))
        assert row["samples_per_sec_per_device_roofline_bound"] == \
            pytest.approx(row["per_shard_samples"] / (t_comp + t_comm))


def test_markdown_table(audit):
    lines = audit[1].splitlines()
    assert lines[0].startswith("# Communication audit")
    assert "Device: cpu; backend gloo." in lines[2]
    body = [ln for ln in lines if ln.startswith("| ") and "---" not in ln]
    assert len(body) == 1 + 3 * len(MESHES)
    assert "| etsi | 1x4 | 135,200 | 12,800 | 16 | 0 |" in audit[1]


@pytest.fixture(scope="module")
def world_of_one():
    """The tool in this process's started world of one rank."""
    import torch.distributed as dist
    from tetraear_tpu_torch.parallel.distributed import (
        initialize_distributed)
    initialize_distributed("cpu")
    try:
        rows = _main(["--device", "cpu", "--devices", "1", "--scale", "1"])
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    return {r["variant"]: r for r in rows}


@pytest.mark.parametrize("step", ca.STEPS)
def test_runs_in_a_started_world_of_one(world_of_one, step):
    """In a process whose world is started, the tool runs in place: the
    (1, 1) mesh, its bytes the JAX tool's, the link unmeasured and the
    efficiency fields null."""
    assert list(world_of_one) == list(ca.STEPS)
    row = world_of_one[step]
    want = _jax_row(1, 1, step)
    assert row["mesh"] == "1x1"
    assert _calls(row) == _calls(want)
    assert row["sent_bytes"] == [0]
    assert row["result_gather_bytes"] == _gathered_bytes(step, 1, 1)
    assert row["link_source"] == "unmeasured"
    assert row["link_bytes_per_s"] is None
    for key in ("t_comm_s", "comm_compute_ratio", "eff_no_overlap",
                "eff_overlap", "samples_per_sec_per_device_roofline_bound"):
        assert row[key] is None


def test_cuda_without_a_card_exits_before_writing(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    md = tmp_path / "audit.md"
    with pytest.raises(SystemExit, match="--device cpu"):
        ca.main(["--markdown", str(md)])
    assert not md.exists() and capsys.readouterr().out == ""


def test_devices_beyond_the_world_are_refused(capsys):
    with pytest.raises(SystemExit):
        ca.main(["--device", "cpu", "--devices", "2"])
    assert "--virtual N" in capsys.readouterr().err


def test_meshes_are_the_jax_tools():
    assert ca.meshes(8) == [(8, 1), (4, 2), (2, 4), (1, 8)]
    assert ca.meshes(4) == MESHES
    assert ca.meshes(1) == [(1, 1)]


def test_link_rate_between_two_ranks(tmp_path):
    tentry.launch(2, "cpu", torch_parallel_ranks.link_probe, str(tmp_path),
                  timeout=50)
    rate = json.loads((tmp_path / "rate.json").read_text())
    assert np.isfinite(rate) and rate > 0
