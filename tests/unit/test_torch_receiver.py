"""The port's single-carrier receiver (`models/receiver.py`,
`models/receiver_etsi.py`, `ops/resample.py`, the soft demod and the host
decoder's device sync scores) against the JAX package, on the CPU, and
on the card.

Inputs are made with numpy from fixed seeds.  Float stages are held
within stated tolerances (f32 sum orders of different conv, FFT and
filter implementations); decisions — hard symbols, bits, sync scores,
symbol counts, timing phases, decoded frames — must be identical on
planted signals, whose symbols sit a bin's half-width from every
decision edge."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.core.decoder import TetraDecoder as JaxDecoder
from tetraear_tpu.models import receiver as jrx
from tetraear_tpu.models import receiver_etsi as jetsi
from tetraear_tpu.ops import dqpsk as jdq
from tetraear_tpu.ops import fir as jfir
from tetraear_tpu.ops import resample as jrs
from tetraear_tpu.utils import synth

from tetraear_tpu_torch.core.decoder import TetraDecoder
from tetraear_tpu_torch.models import receiver as trx
from tetraear_tpu_torch.models import receiver_etsi as tetsi
from tetraear_tpu_torch.ops import dqpsk as tdq
from tetraear_tpu_torch.ops import fir as tfir
from tetraear_tpu_torch.ops import resample as trs
from tetraear_tpu_torch.utils.synth import planted_single

REPO = Path(__file__).resolve().parents[2]
PROFILES = ("ref-compat", "ref-exact", "etsi")
# x max|reference|: f32 sum order of the FIR / resampler convs and of the
# IIR (whose reference scan is itself 1.4e-5 from float64, test_torch_iir)
FLOAT_TOL = {"ref-compat": 1e-5, "ref-exact": 5e-5, "etsi": 1e-5}
FFT_TOL = 1e-5        # x max|reference|: pocketfft vs XLA's FFT in f32


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


def _noisy(profile, offset_hz=0.0, snr_db=25.0, seed=3):
    """A planted capture with AWGN at snr_db and a carrier offset."""
    x, text = planted_single(profile)
    r = np.random.default_rng(seed)
    t = np.arange(len(x)) / 2.4e6
    x = x * np.exp(2j * np.pi * offset_hz * t)
    std = 10 ** (-snr_db / 20) / np.sqrt(2)
    x = x + std * (r.standard_normal(len(x)) + 1j * r.standard_normal(len(x)))
    return x.astype(np.complex64), text


def _phase_tol(offset_hz, n):
    """Two f32 ulps of the shift's largest phase 2 pi f n / fs: the
    reference's jitted block takes t = i * f32(1/fs) (XLA's rewrite of a
    division by a constant), the port t = i / fs as the eager op."""
    ph = 2 * np.pi * abs(offset_hz) * n / 2.4e6
    return 2 * float(np.spacing(np.float32(ph))) if ph else 0.0


def _assert_same_result(got, want, profile, offset_hz=0.0, n=0):
    """Port DemodResult / EtsiDemodResult against the reference's."""
    count = int(want.count)
    assert int(got.count) == count and int(got.best_phase) == int(
        want.best_phase)
    m = count - 1
    _close(got.symbols_iq.cpu().numpy()[:count],
           np.asarray(want.symbols_iq)[:count],
           FLOAT_TOL[profile] + _phase_tol(offset_hz, n))
    np.testing.assert_array_equal(got.hard_symbols.cpu().numpy()[:m],
                                  np.asarray(want.hard_symbols)[:m])
    np.testing.assert_array_equal(got.bits.cpu().numpy()[:2 * m],
                                  np.asarray(want.bits)[:2 * m])
    # the scores k / 44: the reference's jitted block multiplies by
    # f32(1/44) (XLA's rewrite of a division by a constant), the port
    # divides as the reference's eager op does, so a score may differ by
    # one ulp; every threshold decision is the same
    gc = got.sync_corr.cpu().numpy()[:2 * m - 21]
    wc = np.asarray(want.sync_corr)[:2 * m - 21]
    np.testing.assert_allclose(gc, wc, rtol=0, atol=6e-8)
    np.testing.assert_array_equal(np.round(gc * 44), np.round(wc * 44))
    for th in (0.8, 0.85, 0.86, 0.9):
        np.testing.assert_array_equal(gc >= th, wc >= th)
    if profile == "etsi":
        _close(got.soft_bits.cpu().numpy()[:m],
               np.asarray(want.soft_bits)[:m], 1e-4)


class TestDesigners:
    def test_rrc_and_resampler_taps_equal_the_reference(self):
        np.testing.assert_array_equal(tfir.design_rrc(40, 0.35, 10),
                                      jfir.design_rrc(40, 0.35, 10))
        np.testing.assert_array_equal(tfir.design_rrc(8, 0.25, 6),
                                      jfir.design_rrc(8, 0.25, 6))
        np.testing.assert_array_equal(trs.design_rrc_resampler(3, 10, 4),
                                      jrs.design_rrc_resampler(3, 10, 4))
        for L, M in ((3, 10), (2, 5), (5, 7)):
            got, gd = trs._phase_plan(401, L, M)
            want, wd = jrs._phase_plan(401, L, M)
            assert gd == wd
            for (gi, gb), (wi, wb) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                assert gb == wb


class TestStages:
    @pytest.mark.parametrize("L,M", [(3, 10), (2, 5), (5, 7)])
    def test_rational_resample(self, L, M):
        r = np.random.default_rng(L * M)
        x = (r.standard_normal((2, 6000)) + 1j * r.standard_normal((2, 6000))
             ).astype(np.complex64)
        taps = jrs.design_rrc_resampler(L, M, 4)
        got = trs.rational_resample(torch.as_tensor(x), L, M, taps).numpy()
        _close(got, jrs.rational_resample(jnp.asarray(x), L, M, taps), 1e-5)
        real = trs.rational_resample(torch.as_tensor(x[0].real), L, M, taps)
        _close(real.numpy(),
               jrs.rational_resample(jnp.asarray(x[0].real), L, M, taps),
               1e-5)

    def test_demodulate_soft(self):
        r = np.random.default_rng(4)
        x = (r.standard_normal((3, 400)) + 1j * r.standard_normal((3, 400))
             ).astype(np.complex64)
        got = tdq.demodulate_soft(torch.as_tensor(x))
        want = jdq.demodulate_soft(jnp.asarray(x))
        np.testing.assert_array_equal(got.symbols.numpy(),
                                      np.asarray(want.symbols))
        np.testing.assert_allclose(got.dphi.numpy(), np.asarray(want.dphi),
                                   atol=1e-6)
        np.testing.assert_allclose(got.magnitude.numpy(),
                                   np.asarray(want.magnitude), rtol=1e-6)
        np.testing.assert_allclose(got.soft_bits.numpy(),
                                   np.asarray(want.soft_bits), atol=1e-6)
        zr, zi = r.standard_normal((2, 1000)).astype(np.float32)
        np.testing.assert_array_equal(
            tdq.quantize_z_etsi(torch.as_tensor(zr), torch.as_tensor(zi)),
            np.asarray(jdq.quantize_z_etsi(jnp.asarray(zr), jnp.asarray(zi))))

    @pytest.mark.parametrize("n,new_n", [(1000, 333), (999, 1500), (64, 64)])
    def test_fft_resample(self, n, new_n):
        r = np.random.default_rng(n)
        x = (r.standard_normal(n) + 1j * r.standard_normal(n)
             ).astype(np.complex64)
        got = trx._fft_resample(torch.fft.fft(torch.as_tensor(x)), n, new_n)
        want = jrx._fft_resample(jnp.fft.fft(jnp.asarray(x)), n, new_n)
        _close(got.numpy(), want, FFT_TOL)

    def test_signal_processor_stages(self):
        """The single stages of the reference's SignalProcessor API, each
        computed on the processor's device."""
        r = np.random.default_rng(5)
        x = (r.standard_normal(24000) + 1j * r.standard_normal(24000)
             ).astype(np.complex64)
        for profile in ("ref-compat", "ref-exact"):
            cfg = ReceiverConfig(profile=profile)
            sp = trx.SignalProcessor(config=cfg, device="cpu")
            ref = jrx.SignalProcessor(config=cfg)
            _close(sp.filter_signal(x), ref.filter_signal(x),
                   FLOAT_TOL[profile])
            _close(sp.resample(x, 240e3), ref.resample(x, 240e3), FFT_TOL)
            _close(sp.frequency_shift(x, 700.0), ref.frequency_shift(x, 700.0),
                   5e-6)
            _close(sp.extract_symbols(x, 240e3), ref.extract_symbols(x, 240e3),
                   0.0)
            np.testing.assert_array_equal(sp.demodulate_dqpsk(x[:500]),
                                          ref.demodulate_dqpsk(x[:500]))
        assert sp.filter_signal(np.array([], np.complex64)).size == 0
        assert sp.demodulate_dqpsk(x[:1]).size == 0


class TestFrontend:
    @pytest.mark.parametrize("profile", PROFILES)
    @pytest.mark.parametrize("offset_hz", [0.0, 850.0])
    def test_matches_reference(self, profile, offset_hz):
        """Each profile's block pipeline on a planted noisy capture: the
        same decisions as the reference's jitted Frontend."""
        x, _ = _noisy(profile, offset_hz)
        cfg = ReceiverConfig(profile=profile)
        if profile == "etsi":
            got = tetsi.EtsiReceiver(cfg, device="cpu")(x, offset_hz)
            want = jetsi.EtsiReceiver(cfg)(x, offset_hz)
        else:
            got = trx.Frontend(cfg, device="cpu")(x, offset_hz)
            want = jrx.Frontend(cfg)(x, offset_hz)
        _assert_same_result(got, want, profile, offset_hz, len(x))

    @pytest.mark.parametrize("profile", PROFILES)
    def test_process_and_symbols_side_channel(self, profile):
        x, _ = _noisy(profile, seed=6)
        cfg = ReceiverConfig(profile=profile)
        sp = trx.SignalProcessor(config=cfg, device="cpu")
        ref = jrx.SignalProcessor(config=cfg)
        np.testing.assert_array_equal(sp.process(x, 0.0), ref.process(x, 0.0))
        _close(sp.symbols, ref.symbols, FLOAT_TOL[profile])
        assert sp.symbols.dtype == np.complex64
        full = sp.process_full(x)
        assert isinstance(sp._frontend, tetsi.EtsiReceiver if profile ==
                          "etsi" else trx.Frontend)
        assert hasattr(full, "soft_bits") == (profile == "etsi")
        assert sp.process(np.array([], np.complex64)).size == 0
        assert sp.symbols.size == 0

    def test_etsi_true_rate_symbol_recovery(self):
        """2000 symbols on the true 18 kHz grid come back exactly
        (tests/unit/test_etsi_receiver.py's case through the port)."""
        syms = np.random.default_rng(0).integers(0, 4, 2000)
        x = synth.synthesize_iq(syms, 2.4e6, snr_db=30, mapping="pi4",
                                seed=1)
        out = tetsi.EtsiReceiver(device="cpu").process(x)
        n = min(len(out), len(syms))
        assert n >= 1990 and (out[:n] == syms[:n]).all()
        np.testing.assert_array_equal(out, jetsi.EtsiReceiver().process(x))


class TestTetraDecoder:
    def test_decode_and_find_sync_equal_the_reference(self):
        x, text = _noisy("ref-exact", seed=7)
        hard = trx.SignalProcessor(config=ReceiverConfig(profile="ref-exact"),
                                   device="cpu").process(x)
        got = TetraDecoder(auto_decrypt=False).decode(hard)
        want = JaxDecoder(auto_decrypt=False).decode(hard)
        assert [f.get("sds_message") for f in got] == [
            f.get("sds_message") for f in want]
        assert text in [f.get("sds_message") for f in got]
        assert [f["position"] for f in got] == [f["position"] for f in want]
        bits, _ = TetraDecoder().symbols_to_bits(hard)
        for th in (0.9, 0.6):
            assert (TetraDecoder().find_sync(bits, th, True)
                    == JaxDecoder().find_sync(bits, th, True))
        assert TetraDecoder().decode(hard[:10]) == []
        assert TetraDecoder().find_sync(bits[:10], 0.9, True) == ([], 0.0)

    def test_dense_scores_equal_the_references(self):
        r = np.random.default_rng(8)
        bits = r.integers(0, 2, 3000).astype(np.uint8)
        ts1, ts2 = TetraDecoder().dense_sync(bits)
        from tetraear_tpu.core.decoder import _dense_sync_correlation
        w1, w2 = _dense_sync_correlation(bits)
        np.testing.assert_array_equal(ts1, w1)
        np.testing.assert_array_equal(ts2, w2)

    def test_decode_runs_without_jax(self):
        """The port's decoder, receiver and etsi link never import jax,
        also while they decode."""
        code = (
            "import sys\n"
            "from tetraear_tpu.config import ReceiverConfig\n"
            "from tetraear_tpu_torch.core.decoder import TetraDecoder\n"
            "from tetraear_tpu_torch.models.receiver import SignalProcessor\n"
            "from tetraear_tpu_torch.models.etsi_link import "
            "EtsiLinkReceiver\n"
            "from tetraear_tpu_torch.utils.synth import planted_single\n"
            "x, text = planted_single('ref-exact')\n"
            "sp = SignalProcessor(config=ReceiverConfig(profile='ref-exact'),"
            " device='cpu')\n"
            "dec = TetraDecoder()\n"
            "frames = dec.decode(sp.process(x))\n"
            "assert text in [f.get('sds_message') for f in frames], frames\n"
            "bits = dec.symbols_to_bits(sp.process(x))[0]\n"
            "dec.find_sync(bits)\n"
            "assert dec.find_sync(bits[:10], 0.9, True) == ([], 0.0)\n"
            "assert dec.decode([]) == []\n"
            "EtsiLinkReceiver(device='cpu').receive(x)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib'))]\n"
            "assert not bad, bad[:5]\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("profile", PROFILES)
def test_frontend_on_card_matches_cpu(cuda_device, profile):
    """Each profile's Frontend on the card: every output on the card, the
    same decisions as the CPU's plain run, floats within FLOAT_TOL."""
    x, text = _noisy(profile, 850.0)
    cfg = ReceiverConfig(profile=profile)
    cls = tetsi.EtsiReceiver if profile == "etsi" else trx.Frontend
    got = cls(cfg, device=cuda_device)(x, 850.0)
    assert all(v.device.type == "cuda" for v in got)
    _assert_same_result(got, cls(cfg, device="cpu")(x, 850.0), profile)
    sp = trx.SignalProcessor(config=cfg, device=cuda_device)
    frames = TetraDecoder(device=cuda_device).decode(sp.process(x, 850.0))
    assert text in [f.get("sds_message") for f in frames]
