"""The port's pod-scale receive (tetraear_tpu_torch/parallel/, entry.py)
against the JAX package's, on the CPU.

The port runs one rank per shard: a module fixture spawns one 4-rank
gloo world (FileStore rendezvous, one thread a rank) that runs every
port-side case (torch_parallel_ranks.run_cases, which refuses jax in
each rank) and writes rank 0's gathered global results.  The JAX side
runs here on the conftest's 8-device virtual mesh, at the same mesh
shapes ((1, 4) for the halo primitives, (2, 2) for the steps), on the
same numpy inputs from the port's own synthesizer.

Tolerances are the reference's own (tests/unit/test_parallel.py): the
golden carrier's bits equal on owned interiors, noise carriers' at
least 0.995 (near-zero symbols flip under another f32 sum order), sync
scores within 1e-4, best phases equal and the same on every time shard;
the etsi LLRs within 1e-3 (the soft values differ from JAX's by f32
rounding behind the channelizer) with confident signs equal; the halo
primitives exactly equal."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import fir as jfir
from tetraear_tpu.parallel import halo as jhalo
from tetraear_tpu.parallel import mesh as jmesh
from tetraear_tpu.parallel import sharded as jsh

from tetraear_tpu_torch import entry as tentry
from tetraear_tpu_torch.models.downlink import (DownlinkConfig,
                                                DownlinkTransmitter,
                                                MulticarrierDownlinkReceiver)
from tetraear_tpu_torch.models.multicarrier import StagedMulticarrierFrontend
from tetraear_tpu_torch.ops import fir as tfir
from tetraear_tpu_torch.ops.channelizer import carrier_grid
from tetraear_tpu_torch.parallel import distributed as tdist
from tetraear_tpu_torch.parallel import halo as thalo
from tetraear_tpu_torch.parallel import mesh as tmesh
from tetraear_tpu_torch.parallel import sharded as tsh
from tetraear_tpu_torch.utils import synth

import torch_parallel_ranks

REPO = Path(__file__).resolve().parents[2]
CFG = ReceiverConfig()
STEP = CFG.decimation_factor * CFG.ref_samples_per_symbol       # 130
HALO = 132 * STEP
T_LOCAL = 1040 * STEP                 # per time shard, staged and fused
T_LOCAL_RP = 22 * 6240                # real-pair: a multiple of 6240
OFFSETS = np.array([0.0, 25e3, -25e3, 50e3], np.float32)
HALO_T = 16                           # the halo primitives' block
SLOTS = 7                             # the fewest giving >= 6 frames a cell


def _golden_wideband(n: int) -> np.ndarray:
    """Golden frames on carrier 0 (0 Hz) over complex noise of 0.02."""
    stream = synth.make_stream_bits(num_frames=16, lead_bits=64, seed=2,
                                    golden=True)
    ph = synth.synthesize_symbol_phasors(synth.bits_to_symbols(stream),
                                         mapping="ref")
    sig = synth.upsample_hold(ph, 2.4e6, 2.4e6 / 130.0)
    rng = np.random.default_rng(0)
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[:min(len(sig), n)] += sig[:n]
    return x.astype(np.complex64)


def _two_cells(num_slots: int) -> tuple:
    """Two ETSI downlink cells on carrier_grid(2), "POD CELL c" on their
    SCH/F slots 1 and 5, cut to a multiple of 2 x 400 samples."""
    from tetraear_tpu_torch.utils.synth import make_mac_block_bits
    offsets = carrier_grid(2)
    mix = None
    for c in range(2):
        tx = DownlinkTransmitter(DownlinkConfig(mcc=262, mnc=50 + c,
                                                colour_code=2 + c))
        pay = {k: make_mac_block_bits(f"POD CELL {c}".encode(), seed=c)
               for k in (1, 5)}
        iq = tx.modulate(tx.stream_bits(num_slots, payloads=pay), seed=c)
        t = np.arange(len(iq)) / 2.4e6
        s = iq * np.exp(2j * np.pi * offsets[c] * t)
        mix = s if mix is None else mix[:len(s)] + s[:len(mix)]
    x = (mix / 2).astype(np.complex64)
    return x[:len(x) // 800 * 800], offsets


@pytest.fixture(scope="module")
def inputs():
    x_rp = _golden_wideband(2 * T_LOCAL_RP)
    x_cells, offsets_cells = _two_cells(SLOTS)
    return {"x": x_rp[:2 * T_LOCAL], "x_rp": x_rp, "offsets": OFFSETS,
            "x_cells": x_cells, "offsets_cells": offsets_cells,
            "halo_x": np.arange(4 * HALO_T, dtype=np.float32),
            "halo_t": np.int64(HALO_T)}


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """One spawned 4-rank world runs every port-side case; rank 0's
    gathered results and frames."""
    out = tmp_path_factory.mktemp("pod")
    np.savez(out / "inputs.npz", **inputs)
    tentry.launch(4, "cpu", torch_parallel_ranks.run_cases, str(out),
                  timeout=300)
    res = dict(np.load(out / "results.npz"))
    res.update(json.loads((out / "frames.json").read_text()))
    return res


@pytest.fixture(scope="module")
def mesh22():
    return jmesh.make_mesh(carrier=2, time=2)


def _owned(halo: int, t_local: int, margin: int = 8) -> slice:
    """Bit range of a segment's owned interior, `margin` symbols inside
    the filter edges."""
    h = (halo // CFG.decimation_factor) // CFG.ref_samples_per_symbol
    own = (t_local // CFG.decimation_factor) // CFG.ref_samples_per_symbol
    return slice(2 * (h + margin), 2 * (h + own - margin))


def _hold_step(got_bits, got_corr, got_best, want, halo, t_local):
    want_bits = np.asarray(want.bits)
    want_corr = np.asarray(want.sync_corr)
    want_best = np.asarray(want.best_phase)
    assert got_bits.shape == want_bits.shape
    assert got_corr.shape == want_corr.shape
    np.testing.assert_array_equal(got_best, want_best)
    assert (got_best[:, 0] == got_best[:, 1]).all()
    sl = _owned(halo, t_local)
    for c in range(got_bits.shape[0]):
        for k in range(got_bits.shape[1]):
            agree = (got_bits[c, k, sl] == want_bits[c, k, sl]).mean()
            required = 1.0 if c == 0 else 0.995
            assert agree >= required, (c, k, agree)
    # the golden carrier's sync scores on the owned interior
    corr_sl = slice(sl.start, sl.stop - 21)
    np.testing.assert_allclose(got_corr[0, :, corr_sl],
                               want_corr[0, :, corr_sl], atol=1e-4)


# --- mesh and halo primitives --------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_equals_reference(n):
    assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n)


@pytest.mark.parametrize("decim", [1, 4, 10])
def test_fir_decimate_halo_equals_reference(decim):
    taps = jfir.design_decimation_fir(10, 12)
    g = (len(taps) - 1) // 2
    r = np.random.default_rng(decim)
    cplx = lambda *s: (r.standard_normal(s) + 1j * r.standard_normal(s)
                       ).astype(np.complex64)
    x, lh, rh = cplx(3, 40 * decim), cplx(3, g), cplx(3, g)
    want = np.asarray(jfir.fir_decimate_halo(
        jnp.asarray(x), jnp.asarray(taps), decim, jnp.asarray(lh),
        jnp.asarray(rh)))
    got = tfir.fir_decimate_halo(torch.as_tensor(x), taps, decim,
                                 torch.as_tensor(lh), torch.as_tensor(rh))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # 1-D, as the reference also takes it
    got1 = tfir.fir_decimate_halo(torch.as_tensor(x[0]), taps, decim,
                                  torch.as_tensor(lh[0]),
                                  torch.as_tensor(rh[0]))
    np.testing.assert_allclose(got1.numpy(), want[0], rtol=1e-4, atol=1e-5)


def _jax_halo(fn):
    mesh = jmesh.make_mesh(carrier=1, time=4)
    x = np.arange(4 * HALO_T, dtype=np.float32)
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(jmesh.TIME_AXIS),
        out_specs=P(jmesh.TIME_AXIS), check_vma=False))(jnp.asarray(x)))


def test_exchange_halo_equals_reference(port):
    want = _jax_halo(lambda xl: jnp.concatenate(
        jhalo.exchange_halo(xl, 4, 4, jmesh.TIME_AXIS))).reshape(4, 8)
    np.testing.assert_array_equal(port["halo_exchange"][0], want)


def test_extend_with_halo_equals_reference(port):
    want = _jax_halo(lambda xl: jhalo.extend_with_halo(
        xl, 4, 4, jmesh.TIME_AXIS)).reshape(4, HALO_T + 8)
    np.testing.assert_array_equal(port["halo_extend"][0], want)


def test_carry_last_equals_reference(port):
    want = _jax_halo(lambda xl: jhalo.carry_last(xl, jmesh.TIME_AXIS)[None])
    np.testing.assert_array_equal(port["halo_carry"][0], want)
    np.testing.assert_array_equal(want, [0.0, 15.0, 31.0, 47.0])


# --- the four sharded steps -----------------------------------------------

def test_staged_step_equals_reference(port, inputs, mesh22):
    xs, offs = jsh.shard_inputs(mesh22, inputs["x"], OFFSETS)
    want = jsh.build_sharded_step(mesh22, CFG)(xs, offs)
    _hold_step(port["staged_bits"], port["staged_sync_corr"],
               port["staged_best_phase"], want, HALO, T_LOCAL)


def test_fused_step_equals_reference(port, inputs, mesh22):
    xs, _ = jsh.shard_inputs(mesh22, inputs["x"], OFFSETS)
    want = jsh.build_sharded_step_fused(mesh22, OFFSETS, CFG)(xs)
    _hold_step(port["fused_bits"], port["fused_sync_corr"],
               port["fused_best_phase"], want, HALO, T_LOCAL)


def test_fused_step_interior_equals_staged(port):
    """The port's fused and staged steps agree on the golden carrier's
    owned interiors, as the reference's pair does."""
    sl = _owned(HALO, T_LOCAL, margin=16)
    np.testing.assert_array_equal(port["fused_bits"][0][:, sl],
                                  port["staged_bits"][0][:, sl])
    np.testing.assert_array_equal(port["fused_best_phase"],
                                  port["staged_best_phase"])


def test_realpair_step_equals_reference(port, inputs, mesh22):
    run, halo = jsh.build_sharded_step_realpair(mesh22, CFG)
    assert halo == port["halo_rp"] == 18_720
    want = run(*jsh.realpair_shard_inputs(mesh22, inputs["x_rp"], OFFSETS,
                                          halo, CFG.sample_rate_hz))
    _hold_step(port["realpair_bits"], port["realpair_sync_corr"],
               port["realpair_best_phase"], want, halo, T_LOCAL_RP)


def test_etsi_step_equals_reference(port, inputs, mesh22):
    x, offs = inputs["x_cells"], inputs["offsets_cells"]
    rx = jsh.ShardedDownlinkReceiver(mesh22, num_carriers=2)
    res = rx.run(*jsh.shard_inputs(mesh22, x, offs))
    want = rx.stitch(res, len(x) // 2)
    got = port["etsi_stitched"]
    np.testing.assert_array_equal(port["etsi_best_phase"],
                                  np.asarray(res.best_phase))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3)
    conf = np.abs(want) > 1e-3
    assert np.array_equal(np.sign(got)[conf], np.sign(want)[conf])


# --- the stitching receivers ----------------------------------------------

def test_sharded_receiver_frames_equal_reference(port, inputs, mesh22):
    rx = jsh.ShardedReceiver(mesh22, CFG)
    want = rx.decode(rx(inputs["x"], OFFSETS), T_LOCAL)
    keys = ("number", "timeslot", "sync_position", "carrier", "time_shard",
            "sds_message")
    assert port["staged"] == [[{k: f.get(k) for k in keys} for f in fc]
                              for fc in want]
    nums = [f["number"] for f in port["staged"][0]]
    assert len(nums) >= 8 and len(nums) == len(set(nums))    # exactly once
    assert all(f["sds_message"] == "[TXT] HELLO HELLO"
               for f in port["staged"][0])


def test_sharded_downlink_receiver_equals_unsharded(port, inputs):
    """The pod's frames are the unsharded receiver's, as a prefix (the
    owned regions cover a slightly longer tail than the count-trimmed
    unsharded stream), and each cell's text is found."""
    want = MulticarrierDownlinkReceiver(2, device="cpu").receive(
        inputs["x_cells"])
    for c in range(2):
        pod = [tuple(r) for r in port["cells"][c]]
        ref = [(f.tn, f.fn, f.mn, f.burst_kind, f.crc_ok, f.sds_message,
                None if f.sync_pdu is None else f.sync_pdu.mnc)
               for f in want[c]]
        assert len(pod) >= 6 and len(pod) >= len(ref)
        assert pod[:len(ref)] == ref, c
        assert [r[6] for r in pod if r[6] is not None][0] == 50 + c
        assert any(r[5] and f"POD CELL {c}" in r[5] for r in pod)


# --- entry points ---------------------------------------------------------

def test_entry_candidates_equal_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = tentry.entry(torch.device("cpu"))
    assert isinstance(fn, StagedMulticarrierFrontend)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fn(*args)
    for name in ("count", "cand_pos", "cand_valid", "crc_ok", "frame_bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.cand_corr.numpy(),
                               np.asarray(want.cand_corr), atol=1e-6)


def test_dryrun_multichip_runs_on_four_cpu_ranks():
    tentry.dryrun_multichip(4, "cpu")


def test_launch_propagates_a_rank_failure():
    with pytest.raises(tentry.RankFailed, match="rank 1 fails on purpose"):
        tentry.launch(2, "cpu", torch_parallel_ranks.fail_on_rank_1,
                      timeout=120)


# --- the device rule and the world of one rank ----------------------------

def test_make_mesh_without_a_world_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialized world"):
        tmesh.make_mesh(1, 1, device_type="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tdist.initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()


@pytest.fixture
def world_of_one():
    assert tdist.initialize_distributed("cpu") is False
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_world_of_one(world_of_one):
    """A world of one rank: the (1, 1) mesh, its size rules, and time
    primitives that return without communicating."""
    mesh = tdist.make_global_mesh("cpu")
    assert (mesh.shape, mesh.coords) == ({"carrier": 1, "time": 1},
                                         {"carrier": 0, "time": 0})
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(2, 1, device_type="cpu")
    x = torch.arange(8.0)
    lh, rh = thalo.exchange_halo(x, 2, 3, mesh)
    assert lh.tolist() == [0.0, 0.0] and rh.tolist() == [0.0] * 3
    assert thalo.carry_last(x, mesh, fill=5.0).item() == 5.0
    assert thalo.psum(x, mesh) is x
    assert tdist.host_local_shard(1000) == (0, 910)
    with pytest.raises(ValueError, match="on a cpu mesh"):
        tsh.build_sharded_step(mesh, device="cuda")


def test_one_shard_equals_the_unsharded_frontend(world_of_one, inputs):
    """On a (1, 1) mesh the staged step's owned bits are the unsharded
    staged frontend's: zero halos are the unsharded zero padding."""
    mesh = tmesh.make_mesh(1, 1, device_type="cpu")
    x = inputs["x"]
    rx = tsh.ShardedReceiver(mesh, device="cpu")
    res = rx(x, OFFSETS)
    ref = StagedMulticarrierFrontend.from_offsets(OFFSETS, device="cpu")(x)
    h_bits = 2 * ((HALO // 10) // 13)
    own = 2 * ((len(x) // 10) // 13)
    got = res.bits[:, 0, h_bits:h_bits + own].numpy()
    want = ref.bits[:, :own].numpy()
    sl = slice(16, own - 16)
    np.testing.assert_array_equal(got[0, sl], want[0, sl])
    for c in range(1, 4):
        assert (got[c, sl] == want[c, sl]).mean() >= 0.995, c


def test_a_failed_start_under_a_launcher_raises(monkeypatch):
    """With a launcher's environment present and no rendezvous to reach
    (no MASTER_ADDR), the start raises; it does not go on as a world of
    one, which would decode this rank's block as the whole stream."""
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tdist.initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
