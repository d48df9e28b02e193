"""The port's IIR filters (`tetraear_tpu_torch.ops.iir`) and frequency
shift (`ops.ddc`) against the JAX package's, on the CPU, and on the card.

Inputs are made with numpy from fixed seeds.  The port runs each filter
as chunked state-space matmuls plus a log-depth scan over chunk states,
the reference as an f32 `lax.scan` over samples; both round in f32, in
different orders.  Measured here: the port lies within 2e-6 x max|y| of
scipy's float64 filters, the reference within 1.4e-5 (its sequential f32
recursion through the cheby1-8's poles near the unit circle), so the
two packages are held within ATOL x max|y| of each other and the port
also within F64_TOL x max|y| of scipy."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import signal as sps

from tetraear_tpu.ops import ddc as jddc
from tetraear_tpu.ops import iir as jiir

from tetraear_tpu_torch.ops import ddc as tddc
from tetraear_tpu_torch.ops import iir as tiir

ATOL = 5e-5          # x max|reference|: port vs the JAX package's f32 scan
F64_TOL = 1e-5       # x max|scipy|: port vs scipy's float64 filters
BUTTER_CUT = 12500 / 120000         # the receiver's channel filter cutoff


def _x(shape, seed, complex_=True):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape)
    if complex_:
        x = x + 1j * r.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


class TestDesigners:
    def test_coefficients_equal_the_reference(self):
        for q in (2, 10):
            for got, want in zip(tiir.decimate_coeffs(q),
                                 jiir.decimate_coeffs(q)):
                np.testing.assert_array_equal(got, want)
        for got, want in zip(tiir.butter_coeffs(4, BUTTER_CUT),
                             jiir.butter_coeffs(4, BUTTER_CUT)):
            np.testing.assert_array_equal(got, want)
        b, a = jiir.decimate_coeffs(10)
        for got, want in zip(tiir._tf2sos_zi(tuple(b), tuple(a)),
                             jiir._tf2sos_zi(tuple(b), tuple(a))):
            np.testing.assert_array_equal(got, want)

    def test_chunk_operators_reproduce_the_recursion(self):
        """H, G, F and P of one chunk equal a float64 DF2T recursion run
        from a random state (the operators are exact; f32 comes later)."""
        b, a = sps.butter(3, 0.2)
        s = tiir._system(tiir._tf_sections(b, a))
        r = np.random.default_rng(1)
        x = r.standard_normal(tiir.CHUNK)
        z0 = r.standard_normal(3)
        y, zf = sps.lfilter(b, a, x, zi=z0)
        np.testing.assert_allclose(s.H @ x + s.G @ z0, y, atol=1e-12)
        np.testing.assert_allclose(s.F @ x + s.P[0] @ z0, zf, atol=1e-12)
        np.testing.assert_allclose(s.P[1], s.P[0] @ s.P[0], atol=1e-15)


class TestFilters:
    @pytest.mark.parametrize("complex_", [False, True])
    def test_lfilter(self, complex_):
        b, a = sps.butter(3, 0.2)
        x = _x((3, 5000), 0, complex_)
        _close(tiir.lfilter(b, a, torch.as_tensor(x)).numpy(),
               jiir.lfilter(b, a, jnp.asarray(x)), ATOL)
        zi = np.random.default_rng(2).standard_normal(3)
        _close(tiir.lfilter(b, a, torch.as_tensor(x), zi).numpy(),
               jiir.lfilter(b, a, jnp.asarray(x), jnp.asarray(zi)), ATOL)
        _close(tiir.lfilter(b, a, torch.as_tensor(x), zi).numpy(),
               sps.lfilter(b, a, x.astype(np.complex128 if complex_
                                          else np.float64),
                           zi=np.broadcast_to(zi, (3, 3)))[0].astype(x.dtype),
               F64_TOL)

    def test_biquad(self):
        sos = sps.cheby1(8, 0.05, 0.08, output="sos")
        x = _x((2, 3000), 3)
        zi = np.random.default_rng(4).standard_normal((2, 2)).astype(
            np.complex64)
        _close(tiir._biquad(sos[1], torch.as_tensor(x),
                            torch.as_tensor(zi)).numpy(),
               jiir._biquad(sos[1], jnp.asarray(x), jnp.asarray(zi)), ATOL)

    @pytest.mark.parametrize("with_zi", [False, True])
    def test_sosfilt(self, with_zi):
        sos = sps.cheby1(8, 0.05, 0.08, output="sos")
        x = _x((3, 5000), 5)
        zi = (np.random.default_rng(6).standard_normal((4, 2))
              if with_zi else None)
        got = tiir.sosfilt(sos, torch.as_tensor(x), zi).numpy()
        want = jiir.sosfilt(sos, jnp.asarray(x),
                            None if zi is None else jnp.asarray(zi))
        _close(got, want, ATOL)
        ref64 = (sps.sosfilt(sos, x.astype(np.complex128)) if zi is None
                 else sps.sosfilt(sos, x.astype(np.complex128),
                                  zi=np.broadcast_to(zi[:, None, :],
                                                     (4, 3, 2)))[0])
        _close(got, ref64.astype(np.complex64), F64_TOL)

    @pytest.mark.parametrize("complex_", [False, True])
    def test_filtfilt_batched(self, complex_):
        b, a = jiir.decimate_coeffs(10)
        x = _x((2, 3, 4000), 7, complex_)
        got = tiir.filtfilt(b, a, torch.as_tensor(x)).numpy()
        _close(got, jiir.filtfilt(b, a, jnp.asarray(x)), ATOL)
        _close(got, sps.filtfilt(b, a, x.astype(np.float64 if not complex_
                                                else np.complex128)
                                 ).astype(x.dtype), F64_TOL)

    def test_filtfilt_refuses_short_input(self):
        b, a = jiir.decimate_coeffs(10)
        with pytest.raises(ValueError, match="padlen"):
            tiir.filtfilt(b, a, torch.zeros(27))

    @pytest.mark.parametrize("n", [208_400, 262_144])
    def test_decimate_exact_at_capture_length(self, n):
        """The ref-exact front end on one capture's worth of samples."""
        x = _x(n, 8)
        got = tiir.decimate_exact(torch.as_tensor(x), 10).numpy()
        _close(got, np.asarray(jiir.decimate_exact(jnp.asarray(x), 10)),
               ATOL)
        _close(got, sps.decimate(x.astype(np.complex128), 10
                                 ).astype(np.complex64), F64_TOL)

    # at the clamped cutoff 0.01 the poles sit at radius 0.988 and the
    # reference's f32 scan drifts to 1.4e-4 x max|y| from scipy (the
    # port: 9.3e-6), so that case is held at 3e-4
    @pytest.mark.parametrize("cutoff,tol", [(BUTTER_CUT, ATOL),
                                            (0.001, 3e-4), (1.5, ATOL)])
    def test_butter_filtfilt_exact(self, cutoff, tol):
        """The channel filter, the cutoff clamped to [0.01, 0.99]."""
        x = _x((2, 6000), 9)
        got = tiir.butter_filtfilt_exact(torch.as_tensor(x), cutoff).numpy()
        _close(got, jiir.butter_filtfilt_exact(jnp.asarray(x), cutoff), tol)
        b, a = sps.butter(4, min(0.99, max(0.01, cutoff)))
        _close(got, sps.filtfilt(b, a, x.astype(np.complex128)
                                 ).astype(np.complex64), F64_TOL)

    def test_no_loop_over_samples(self, monkeypatch):
        """The work per call is a fixed number of matmuls plus one per
        doubling of the chunk count: 2^6 times the samples adds six."""
        calls = []
        real = tiir._matmul_f32
        monkeypatch.setattr(tiir, "_matmul_f32",
                            lambda a, b: calls.append(1) or real(a, b))
        b, a = jiir.decimate_coeffs(10)
        counts = []
        for n in (tiir.CHUNK * 16, tiir.CHUNK * 16 * 64):
            calls.clear()
            tiir.lfilter(b, a, torch.zeros(n))
            counts.append(len(calls))
        assert counts[1] - counts[0] == 6, counts


class TestFrequencyShift:
    @pytest.mark.parametrize("start", [0, 12_345_678])
    def test_matches_reference(self, start):
        x = _x((2, 20000), 10)
        got = tddc.frequency_shift(torch.as_tensor(x), -1234.5, 240e3,
                                   start).numpy()
        want = np.asarray(jddc.frequency_shift(jnp.asarray(x), -1234.5,
                                               240e3, start))
        assert got.dtype == np.complex64
        # cos/sin against XLA's complex exp of the same f32 phase: a few
        # ulp of a unit phasor
        _close(got, want, 2e-6 if start == 0 else 5e-6)

    def test_phase_is_the_references_f32_phase(self):
        """t = (start + i) / fs and f32(-2pi) f t, each step in f32: the
        oscillator's angle equals the f32 phase the reference takes."""
        n, fs, f = 4096, 240e3, 777.0
        osc = tddc.frequency_shift(torch.ones(n, dtype=torch.complex64),
                                   f, fs, 1000).numpy()
        t = ((np.float32(1000) + np.arange(n, dtype=np.float32))
             / np.float32(fs))
        ph = (np.float32(f) * np.float32(-2 * np.pi)) * t
        np.testing.assert_allclose(np.angle(osc * np.exp(-1j * ph)), 0.0,
                                   atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("complex_", [False, True])
def test_iir_on_card_matches_cpu(cuda_device, complex_):
    """decimate_exact and the channel filtfilt on the card against the
    same plain PyTorch on the CPU (cuBLAS's f32 sum order)."""
    x = _x((2, 262_144), 11, complex_)
    for fn in (lambda v: tiir.decimate_exact(v, 10),
               lambda v: tiir.butter_filtfilt_exact(v, BUTTER_CUT)):
        got = fn(torch.as_tensor(x, device=cuda_device))
        assert got.device.type == "cuda"
        _close(got.cpu().numpy(), fn(torch.as_tensor(x)).numpy(), 1e-5)
