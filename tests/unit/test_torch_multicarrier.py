"""The port's 16-carrier full decode against the JAX reference, on the CPU.

Both packages convolve with the identical composite kernel
(`MulticarrierFrontend.from_reference` takes the reference's
`fused_kernel` output).  The f32 paths must give identical decisions;
the bf16 paths must decode the same planted bursts."""

import numpy as np
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models import multicarrier as jmc
from tetraear_tpu.ops import fused as jfused

from tetraear_tpu_torch.models import multicarrier as tmc
from tetraear_tpu_torch.ops.kernels import s2d_conv as k1

CFG = ReceiverConfig()
CUTOFF = (CFG.channel_bandwidth_hz / 2) / (CFG.intermediate_rate_hz / 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _reference_kernel(offsets):
    kernel, gc, rot = jfused.fused_kernel(
        np.asarray(offsets, np.float64), CFG.sample_rate_hz,
        CFG.decimation_factor, CFG.decim_fir_taps_per_phase,
        CFG.channel_fir_taps, CUTOFF)
    return np.asarray(kernel), gc, np.asarray(rot)


def _port(offsets, conv, device="cpu", **kw):
    return tmc.MulticarrierFrontend.from_reference(
        *_reference_kernel(offsets), CFG, device=device, conv=conv, **kw)


def _np(res):
    return type(res)(*(np.asarray(v.cpu()) if isinstance(v, torch.Tensor)
                       else np.asarray(v) for v in res))


def _wideband():
    """Three planted golden-slot carriers at -25/0/+25 kHz (the recipe of
    test_fused_frontend.py:TestDecisionEquivalence._wideband)."""
    from tetraear_tpu.utils import synth
    fs = 2.4e6
    x = None
    for seed, off in [(1, -25e3), (2, 0.0), (3, 25e3)]:
        st = synth.make_stream_bits(
            num_frames=4, lead_bits=64, seed=seed, golden=True,
            payload=f"CARRIER {seed} MSG".encode()[:20])
        ph = synth.synthesize_symbol_phasors(synth.bits_to_symbols(st),
                                             mapping="ref")
        iq = synth.upsample_hold(ph, fs, fs / 130.0)
        if x is None:
            x = np.zeros(len(iq), np.complex64)
        t = np.arange(len(x)) / fs
        x += (iq[:len(x)] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    return x


WIDEBAND_OFFSETS = np.array([-25e3, 0.0, 25e3], np.float32)


@pytest.fixture(scope="module")
def wideband():
    return _wideband()


@pytest.fixture(scope="module")
def jax_wideband(wideband):
    """JAX pallas_bf16, pallas_of4_bf16 and s2d results (numpy) on the
    planted signal."""
    return {v: _np(jmc.MulticarrierFrontend(fused=v)(wideband,
                                                     WIDEBAND_OFFSETS))
            for v in ("pallas_bf16", "pallas_of4_bf16", "s2d")}


def _assert_same_valid_candidates(a, b, rows=None):
    """cand_valid equal; positions, frames and CRC verdicts equal where
    valid (the test_fused_frontend.py:665-695 check)."""
    rows = range(a.cand_valid.shape[0]) if rows is None else rows
    for c in rows:
        va, vb = a.cand_valid[c], b.cand_valid[c]
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(a.cand_pos[c][va], b.cand_pos[c][vb])
        np.testing.assert_array_equal(a.frame_bits[c][va],
                                      b.frame_bits[c][vb])
        np.testing.assert_array_equal(a.crc_ok[c][va], b.crc_ok[c][vb])


class TestFrontendParity:
    @pytest.mark.parametrize("conv", ["s2d", "pallas", "s2d_of",
                                      "pallas_of4", "pallas_db"])
    def test_noise_bit_identical_to_jax_s2d(self, conv):
        """f32 conv on both sides (sum order apart): bits, counts,
        candidate positions, frames and CRC verdicts identical; the
        scores < 1e-5, as test_fused_frontend.py:393-398 pins pallas
        against s2d (inside jit, XLA may divide by 44 as a multiply by
        its reciprocal: one ulp)."""
        r = np.random.default_rng(0x16C)
        n = 40_000
        x = ((r.standard_normal(n) + 1j * r.standard_normal(n)) * 0.1
             ).astype(np.complex64)
        offs = ((np.arange(16) - 8) * 25e3).astype(np.float64)
        want = _np(jmc.MulticarrierFrontend(CFG, num_candidates=32,
                                            fused="s2d")(x, offs))
        got = _np(_port(offs, conv, num_candidates=32)(x))
        for field in ("bits", "count", "cand_pos", "cand_valid",
                      "frame_bits", "crc_ok"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), err_msg=field)
        for field in ("sync_corr", "cand_corr"):
            assert np.abs(getattr(got, field)
                          - getattr(want, field)).max() < 1e-5, field

    def test_pallas_bf16_decodes_like_jax(self, wideband, jax_wideband):
        """bf16 operands on both sides: the port's pallas_bf16 decodes the
        same per-carrier SDS texts as the JAX pallas_bf16, and its
        candidates and CRC verdicts agree on valid slots."""
        self._decodes_like_jax("pallas_bf16", wideband, jax_wideband)

    def test_pallas_of4_bf16_decodes_like_jax(self, wideband, jax_wideband):
        """The same for the output-folded K1-of with bf16 operands."""
        self._decodes_like_jax("pallas_of4_bf16", wideband, jax_wideband)

    @staticmethod
    def _decodes_like_jax(conv, wideband, jax_wideband):
        got = _port(WIDEBAND_OFFSETS, conv)(wideband)
        want = jax_wideband[conv]
        _assert_same_valid_candidates(_np(got), want)
        port_frames = tmc.MulticarrierDecoder(3, device="cpu").decode(got)
        jax_frames = jmc.MulticarrierDecoder(3).decode(
            jmc.MulticarrierResult(*want))
        for c in range(3):
            texts = {f.get("sds_message") for f in port_frames[c]}
            assert texts == {f.get("sds_message") for f in jax_frames[c]}
            assert f"[TXT] CARRIER {c + 1} MSG" in texts

    def test_pallas_bf16_planted_candidates_match_jax_s2d(self, wideband,
                                                          jax_wideband):
        """bf16 against the f32 reference: decisions on the planted
        carriers' valid candidates are identical."""
        got = _np(_port(WIDEBAND_OFFSETS, "pallas_bf16")(wideband))
        want = jax_wideband["s2d"]
        hot = np.where((want.crc_ok & want.cand_valid).any(axis=-1))[0]
        assert hot.size == 3
        _assert_same_valid_candidates(got, want, rows=hot)


class TestFrontendModule:
    def test_buffers_and_own_builder(self):
        """from_offsets (the port's designers) builds the same buffers as
        from_reference (the reference's fused_kernel)."""
        offs = np.array([-50e3, 0.0, 75e3], np.float32)
        own = tmc.MulticarrierFrontend.from_offsets(offs, CFG, device="cpu")
        ref = _port(offs, "pallas_bf16")
        names = {"kernel_s2d", "z_cos", "z_sin", "crc_a", "crc_c0"}
        assert set(dict(own.named_buffers())) == names
        for name in names:
            assert torch.equal(getattr(own, name), getattr(ref, name)), name
        kernel, gc, rot = _reference_kernel(offs)
        np.testing.assert_array_equal(
            own.kernel_s2d.numpy(),
            np.asarray(jfused.s2d_kernel(kernel, CFG.decimation_factor)))
        assert own.kernel_s2d.shape == (6, 20, 77)
        assert (own.gc, own.L, own.decim) == (gc, kernel.shape[-1], 10)
        assert own.conv == "pallas_bf16" and own.num_candidates == 64

    def test_folded_convs_carry_the_folded_kernel(self):
        """s2d_of folds by max(1, min(8, 128 // C2)) (8 for C2 = 6),
        pallas_of<N> by N; the buffer is the reference's s2d_of_kernel."""
        kernel, _, _ = _reference_kernel(WIDEBAND_OFFSETS)
        for conv, fold in (("s2d_of", 8), ("pallas_of4", 4),
                           ("pallas_of6_bf16", 6)):
            mc = _port(WIDEBAND_OFFSETS, conv)
            assert mc.fold == fold
            np.testing.assert_array_equal(
                mc.kernel_of.numpy(),
                np.asarray(jfused.s2d_of_kernel(kernel, 10, fold)))
        assert "kernel_of" not in dict(
            _port(WIDEBAND_OFFSETS, "pallas_db").named_buffers())

    def test_unknown_variant_raises(self):
        """Unknown names, folds K1-of does not take, and the staged chains
        (frontends of their own: build_frontend) are refused."""
        for bad in ("pallas_hb16", "pallas_of", "pallas_of7", "pallas_ofx",
                    "pallas_of4_f16", "pallas_of<N>", "fused_ri", "s2d_mono",
                    "staged", "gather"):
            with pytest.raises(ValueError):
                _port(WIDEBAND_OFFSETS, bad)

    def test_result_does_not_depend_on_start_index(self):
        """The residual rotation is a per-carrier constant on z, so the
        block's start index does not enter the grid-locked s2d path."""
        r = np.random.default_rng(5)
        x = ((r.standard_normal(9_000) + 1j * r.standard_normal(9_000))
             * 0.1).astype(np.complex64)
        mc = _port(WIDEBAND_OFFSETS, "s2d", num_candidates=4)
        a, b = mc(x), mc(x, start_index=13 * 96)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_pallas_bf16_on_card_decodes_planted(cuda_device, wideband):
    """K1 on the card: every planted text on its carrier, K1's tensor-core
    route launched, and the planted carriers' valid candidates equal the
    CPU f32 path's."""
    _card_decodes_planted("pallas_bf16", "s2d_conv_bf16", cuda_device,
                          wideband)


@pytest.mark.cuda
@pytest.mark.parametrize("conv,wrapper", [("pallas_of4_bf16",
                                           "s2d_conv_of_bf16"),
                                          ("pallas_db", "s2d_conv_db")])
def test_k1_of_and_k3_on_card_decode_planted(cuda_device, wideband, conv,
                                             wrapper):
    """The same through K1-of (bf16 operands) and K3."""
    _card_decodes_planted(conv, wrapper, cuda_device, wideband)


def _card_decodes_planted(conv, wrapper, cuda_device, wideband):
    before = k1.LAUNCHES[wrapper]
    got = _port(WIDEBAND_OFFSETS, conv, device=cuda_device)(wideband)
    assert k1.LAUNCHES[wrapper] == before + 1
    frames = tmc.MulticarrierDecoder(3, device=cuda_device).decode(got)
    for c in range(3):
        assert f"[TXT] CARRIER {c + 1} MSG" in {
            f.get("sds_message") for f in frames[c]}
    cpu = _np(_port(WIDEBAND_OFFSETS, "s2d")(wideband))
    hot = np.where((cpu.crc_ok & cpu.cand_valid).any(axis=-1))[0]
    _assert_same_valid_candidates(_np(got), cpu, rows=hot)
