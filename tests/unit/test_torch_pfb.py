"""The port's full-band filterbank decode (96 channels at 2.4 MS/s)
against the JAX reference, on the CPU.

Both packages convolve with the identical filterbank kernel
(`PfbMulticarrierFrontend.from_reference` takes the reference's
`fused.pfb_kernel` output).  The f32 convs must give identical
decisions; the bf16 conv must decode the same planted bursts."""

import numpy as np
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models import multicarrier as jmc
from tetraear_tpu.ops import fused as jfused
from tetraear_tpu.ops import pfb as jpfb

from tetraear_tpu_torch.models import multicarrier as tmc
from tetraear_tpu_torch.ops import fused as tfused
from tetraear_tpu_torch.ops import pfb as tpfb
from tetraear_tpu_torch.ops.kernels import s2d_conv as k1
from tetraear_tpu_torch.utils.synth import planted_pfb

CFG = ReceiverConfig()
FS = CFG.sample_rate_hz


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _np(res):
    return type(res)(*(np.asarray(v.cpu()) if isinstance(v, torch.Tensor)
                       else np.asarray(v) for v in res))


def _port(conv, device="cpu", **kw):
    kernel, gc, rot = jfused.pfb_kernel(96, FS)
    return tmc.PfbMulticarrierFrontend.from_reference(
        np.asarray(kernel), gc, np.asarray(rot), CFG, device=device,
        conv=conv, **kw)


def _texts(frames):
    return [{f.get("sds_message") for f in per} for per in frames]


@pytest.fixture(scope="module")
def noise():
    r = np.random.default_rng(0x96C)
    n = 48_000
    return ((r.standard_normal(n) + 1j * r.standard_normal(n)) * 0.1
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def jax_noise(noise):
    """JAX PfbMulticarrierFrontend(fused="s2d") on the noise block."""
    return _np(jmc.PfbMulticarrierFrontend(num_candidates=16,
                                           fused="s2d")(noise))


@pytest.fixture(scope="module")
def planted():
    """The three planted channels of test_pfb.py:TestPfbFrontend."""
    return planted_pfb((-50e3, 0.0, 75e3))


class TestBuilders:
    @pytest.mark.parametrize("num_channels,taps_per_branch",
                             [(96, 8), (8, 6), (16, 4)])
    def test_prototype_and_offsets_equal(self, num_channels,
                                         taps_per_branch):
        np.testing.assert_array_equal(
            tpfb.design_prototype(num_channels, taps_per_branch),
            jpfb.design_prototype(num_channels, taps_per_branch))
        np.testing.assert_array_equal(
            tpfb.channel_offsets_hz(num_channels, FS),
            jpfb.channel_offsets_hz(num_channels, FS))

    def test_pfb_kernel_equal(self):
        """The filterbank as one conv: (192, 2, 768), gc = 0, and the
        rotation cycles, bit for bit; its s2d form has 77 taps."""
        tk, tgc, trot = tfused.pfb_kernel(96, FS)
        jk, jgc, jrot = jfused.pfb_kernel(96, FS)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(trot, np.asarray(jrot))
        assert tgc == jgc == 0 and tk.shape == (192, 2, 768)
        np.testing.assert_array_equal(
            tfused.s2d_kernel(tk, 10), np.asarray(jfused.s2d_kernel(jk, 10)))
        assert tfused.s2d_kernel(tk, 10).shape == (192, 20, 77)


class TestPfbFrontendParity:
    @pytest.mark.parametrize("conv", ["s2d", "pallas", "pallas_db"])
    def test_noise_bit_identical_to_jax_s2d(self, conv, noise, jax_noise):
        """f32 convs on both sides (sum order apart): bits, counts,
        candidate positions, validity, frames and CRC verdicts identical
        over all 96 channels; scores < 1e-5 (one ulp of j/44 sums)."""
        got = _np(_port(conv, num_candidates=16)(noise))
        assert got.bits.shape[0] == 96
        for field in ("bits", "count", "cand_pos", "cand_valid",
                      "frame_bits", "crc_ok"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(jax_noise, field),
                                          err_msg=field)
        for field in ("sync_corr", "cand_corr"):
            assert np.abs(getattr(got, field)
                          - getattr(jax_noise, field)).max() < 1e-5, field

    def test_pallas_bf16_decodes_planted_like_jax(self, planted):
        """bf16 operands on both sides: every planted text on its fftfreq
        channel, and per channel the same texts as the JAX pallas_bf16."""
        x, want = planted
        assert set(want) == {94, 0, 3}
        got = tmc.MulticarrierDecoder(96, device="cpu").decode(_port("pallas_bf16")(x))
        ref = jmc.MulticarrierDecoder(96).decode(
            jmc.PfbMulticarrierFrontend(fused="pallas_bf16")(x))
        assert _texts(got) == _texts(ref)
        for c, text in want.items():
            assert text in _texts(got)[c], (c, text)


class TestPfbFrontendModule:
    def test_channels_and_own_builder(self):
        """96 channels in fftfreq order, as the reference's; from_config
        (the port's designers) builds the same buffers as from_reference."""
        own = tmc.PfbMulticarrierFrontend.from_config(CFG, device="cpu",
                                                      conv="pallas_db")
        ref = _port("pallas_db")
        assert own.num_channels == ref.num_channels == 96
        np.testing.assert_array_equal(
            own.channel_offsets_hz(),
            jmc.PfbMulticarrierFrontend(CFG).channel_offsets_hz())
        for name, buf in ref.named_buffers():
            assert torch.equal(getattr(own, name), buf), name
        assert (own.gc, own.L, own.decim, own.kernel_s2d.shape) == (
            0, 768, 10, (192, 20, 77))

    def test_unknown_variant_raises(self):
        """The 16-carrier folds, the TPU-scheduling variants, unknown
        names and the staged chains (frontends of their own) are refused,
        as the reference refuses unknown PFB names."""
        for bad in ("s2d_of", "pallas_of4", "pallas_of4_bf16", "pallas_hb16",
                    "pallas_mono", "s2d_mono", "s2d_hb16", "gather",
                    "staged"):
            with pytest.raises(ValueError, match="PFB"):
                _port(bad)


@pytest.mark.cuda
def test_pallas_db_on_card_decodes_planted(cuda_device, planted):
    """K3 on the card over the full band: K3 launched, every planted text
    on its fftfreq channel, and the planted channels' valid candidates
    equal the CPU f32 path's."""
    x, want = planted
    before = k1.LAUNCHES["s2d_conv_db"]
    got = _port("pallas_db", device=cuda_device)(x)
    assert k1.LAUNCHES["s2d_conv_db"] == before + 1
    texts = _texts(tmc.MulticarrierDecoder(96, device="cpu").decode(got))
    for c, text in want.items():
        assert text in texts[c], (c, text)
    got, cpu = _np(got), _np(_port("s2d")(x))
    for c in want:
        va, vb = got.cand_valid[c], cpu.cand_valid[c]
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(got.cand_pos[c][va], cpu.cand_pos[c][vb])
        np.testing.assert_array_equal(got.crc_ok[c][va], cpu.crc_ok[c][vb])
