"""tetraear_tpu_torch ops against the JAX reference, on the CPU.

Inputs are made with numpy from fixed seeds and go through both
packages; the Pallas kernel runs in interpret mode, as the reference's
own tests run it.  Each case states its tolerance and why."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tetraear_tpu import constants as C
from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.models import multicarrier as jmc
from tetraear_tpu.models import realpair as jrp
from tetraear_tpu.ops import channelizer as jch
from tetraear_tpu.ops import crc as jcrc
from tetraear_tpu.ops import dqpsk as jdq
from tetraear_tpu.ops import fir as jfir
from tetraear_tpu.ops import fused as jfused
from tetraear_tpu.ops import sync as jsync
from tetraear_tpu.ops.pallas.s2d_conv import pallas_s2d_conv
from tetraear_tpu.utils import synth

from tetraear_tpu_torch.models import multicarrier as tmc
from tetraear_tpu_torch.models import realpair as trp
from tetraear_tpu_torch.ops import channelizer as tch
from tetraear_tpu_torch.ops import crc as tcrc
from tetraear_tpu_torch.ops import dqpsk as tdq
from tetraear_tpu_torch.ops import fir as tfir
from tetraear_tpu_torch.ops import fused as tfused
from tetraear_tpu_torch.ops import sync as tsync
from tetraear_tpu_torch.ops.kernels import s2d_conv as k1

CFG = ReceiverConfig()
D = CFG.decimation_factor
CUTOFF = (CFG.channel_bandwidth_hz / 2) / (CFG.intermediate_rate_hz / 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _kernel(num_carriers):
    """Reference composite kernel on carrier_grid(num_carriers), or the
    full-band filterbank's (gc = 0, L = 768) for "pfb"."""
    if num_carriers == "pfb":
        kernel, gc, rot = jfused.pfb_kernel(96, CFG.sample_rate_hz)
        return np.asarray(kernel), gc, np.asarray(rot)
    offs = jch.carrier_grid(num_carriers).astype(np.float64)
    kernel, gc, rot = jfused.fused_kernel(
        offs, CFG.sample_rate_hz, D, CFG.decim_fir_taps_per_phase,
        CFG.channel_fir_taps, CUTOFF)
    return np.asarray(kernel), gc, np.asarray(rot)


def _noise(n, seed):
    r = np.random.default_rng(seed)
    return ((r.standard_normal(n) + 1j * r.standard_normal(n)) * 0.1
            ).astype(np.complex64)


# --- host builders: exact copies ------------------------------------------

class TestBuilders:
    def test_fir_designers_equal(self):
        np.testing.assert_array_equal(
            tfir.design_decimation_fir(D, CFG.decim_fir_taps_per_phase),
            jfir.design_decimation_fir(D, CFG.decim_fir_taps_per_phase))
        np.testing.assert_array_equal(tfir.design_decimation_fir(4),
                                      jfir.design_decimation_fir(4))
        np.testing.assert_array_equal(
            tfir.design_channel_fir(CFG.channel_fir_taps, CUTOFF),
            jfir.design_channel_fir(CFG.channel_fir_taps, CUTOFF))
        np.testing.assert_array_equal(tfir.design_channel_fir(64, 0.3),
                                      jfir.design_channel_fir(64, 0.3))

    @pytest.mark.parametrize("num_carriers", [3, 16])
    def test_fused_kernel_and_s2d_equal(self, num_carriers):
        offs = jch.carrier_grid(num_carriers).astype(np.float64)
        args = (offs, CFG.sample_rate_hz, D, CFG.decim_fir_taps_per_phase,
                CFG.channel_fir_taps, CUTOFF)
        jk, jgc, jrot = jfused.fused_kernel(*args)
        tk, tgc, trot = tfused.fused_kernel(*args)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(trot, np.asarray(jrot))
        assert tgc == jgc == 380
        k2 = tfused.s2d_kernel(tk, D)
        assert k2.shape == (2 * num_carriers, 2 * D, 77)
        np.testing.assert_array_equal(k2, np.asarray(jfused.s2d_kernel(jk, D)))
        for got, want in zip(
                tfused.symbol_rotation(trot, D, CFG.ref_samples_per_symbol),
                jfused.symbol_rotation(jrot, D, CFG.ref_samples_per_symbol)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("fold", [1, 4, 6, 8])
    def test_s2d_of_kernel_equal(self, fold):
        kernel, _, _ = _kernel(16)
        got = tfused.s2d_of_kernel(kernel, D, fold)
        assert got.shape == (32 * fold, 2 * D, 77 + fold - 1)
        np.testing.assert_array_equal(
            got, np.asarray(jfused.s2d_of_kernel(kernel, D, fold)))

    def test_crc_matrix_and_grid_equal(self):
        for m in (16, 200, 331):
            a, c0 = tcrc._crc_matrix(m)
            ja, jc0 = jcrc._crc_matrix(m)
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(c0, jc0)
        for n in (1, 3, 16, 96):
            np.testing.assert_array_equal(tch.carrier_grid(n),
                                          jch.carrier_grid(n))


# --- the composite conv ---------------------------------------------------

class TestS2dConv:
    @pytest.mark.parametrize("num_carriers", [4, 16])
    @pytest.mark.parametrize("n", [40_000, 40_007, 12_345])
    def test_plain_matches_reference(self, n, num_carriers):
        """F.conv1d vs fused._s2d_conv: the same contraction summed in
        another order — f32 sum-order tolerance, as the reference pins
        its Pallas kernel (test_pallas_kernels.py:94)."""
        kernel, gc, _ = _kernel(num_carriers)
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        x = _noise(n, n ^ num_carriers)
        want = np.asarray(jfused._s2d_conv(jnp.asarray(x), k2, gc,
                                           kernel.shape[-1], D))
        got = k1.s2d_conv_plain(torch.from_numpy(x), torch.from_numpy(k2),
                                gc, kernel.shape[-1], D).numpy()
        assert got.shape == want.shape == (2 * num_carriers, -(-n // D))
        assert np.abs(got - want).max() < 4e-6 * np.abs(want).max()

    def test_bf16_plain_matches_pallas_bf16(self):
        """Both cast x and the kernel to bf16 and accumulate in f32, so
        the products are equal and only the sum order differs: the f32
        sum-order bound.  Against the f32 conv, bf16 rounding moves the
        result by < 1e-2 of its scale (test_pallas_kernels.py:186)."""
        kernel, gc, _ = _kernel(16)
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        L = kernel.shape[-1]
        x = _noise(40_000, 0xBF16)
        want = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc, L, D,
                                          variant="bf16"))
        got = k1.s2d_conv_plain(torch.from_numpy(x), torch.from_numpy(k2),
                                gc, L, D, bf16=True).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 4e-6 * np.abs(want).max()
        f32 = np.asarray(jfused._s2d_conv(jnp.asarray(x), k2, gc, L, D))
        assert np.abs(got - f32).max() < 1e-2 * np.abs(f32).max()

    def test_wrapper_runs_plain_on_cpu(self):
        """A CPU tensor takes the plain version (same function, so equal
        bit for bit) and is no launch of K1, K1-of or K3."""
        kernel, gc, _ = _kernel(4)
        L = kernel.shape[-1]
        k2 = torch.from_numpy(tfused.s2d_kernel(kernel, D))
        k_of = torch.from_numpy(tfused.s2d_of_kernel(kernel, D, 4))
        x = torch.from_numpy(_noise(5_003, 5))
        before = dict(k1.LAUNCHES)
        for bf16 in (False, True):
            got = k1.s2d_conv(x, k2, gc, L, D, bf16=bf16)
            want = k1.s2d_conv_plain(x, k2, gc, L, D, bf16=bf16)
            assert torch.equal(got, want)
            got = k1.s2d_conv_of(x, k_of, gc, L, D, 4, bf16=bf16)
            want = k1.s2d_conv_of_plain(x, k_of, gc, L, D, 4, bf16=bf16)
            assert torch.equal(got, want)
        assert torch.equal(k1.s2d_conv_db(x, k2, gc, L, D),
                           k1.s2d_conv_plain(x, k2, gc, L, D))
        assert k1.LAUNCHES == before

    @pytest.mark.parametrize("n", [40_000, 40_007, 12_345])
    def test_of_plain_matches_reference(self, n):
        """The folded plain conv vs fused._s2d_conv_folded and the JAX
        Pallas of4 / of4_bf16 variants: f32 sum-order tolerance; the bf16
        one within 1e-2 of the f32 scale (test_pallas_kernels.py:188-208)
        and, both sides rounding the operands alike, within the sum-order
        bound of the JAX bf16 kernel."""
        kernel, gc, _ = _kernel(16)
        L = kernel.shape[-1]
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        k_of = np.array(jfused.s2d_of_kernel(kernel, D, 4))
        x = _noise(n, 0x0F4 ^ n)
        want = np.asarray(jfused._s2d_conv_folded(jnp.asarray(x), k_of, gc,
                                                  L, D, 4))
        xt, kt = torch.from_numpy(x), torch.from_numpy(k_of)
        got = k1.s2d_conv_of_plain(xt, kt, gc, L, D, 4).numpy()
        scale = np.abs(want).max()
        assert got.shape == want.shape == (32, -(-n // D))
        assert np.abs(got - want).max() < 4e-6 * scale
        jof4 = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc, L, D,
                                          variant="of4"))
        assert np.abs(got - jof4).max() < 4e-6 * scale
        gotb = k1.s2d_conv_of_plain(xt, kt, gc, L, D, 4, bf16=True).numpy()
        jof4b = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc, L, D,
                                           variant="of4_bf16"))
        assert np.abs(gotb - want).max() < 1e-2 * scale
        assert np.abs(gotb - jof4b).max() < 4e-6 * scale

    def test_db_matches_jax_db(self):
        """The port's pallas_s2d_conv(variant="db") vs the JAX one: the
        reference pins db within 1e-6 of the XLA conv
        (test_pallas_kernels.py:149-162)."""
        kernel, gc, _ = _kernel(16)
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        x = _noise(40_007, 0xDB)
        want = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc,
                                          kernel.shape[-1], D, variant="db"))
        got = k1.pallas_s2d_conv(torch.from_numpy(x), k2, gc,
                                 kernel.shape[-1], D, variant="db").numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-6

    def test_pallas_s2d_conv_routes_variants(self):
        """On the CPU each variant is its kernel's plain version, bit for
        bit, dt / dt_bf16 (K4) included, and no launch is counted; folds
        over 2D * fold = 128 and unknown names are refused."""
        kernel, gc, _ = _kernel(4)
        L = kernel.shape[-1]
        k2 = tfused.s2d_kernel(kernel, D)
        kt = torch.from_numpy(k2)
        x = torch.from_numpy(_noise(3_001, 3))
        plain = {"dma": k1.s2d_conv_plain(x, kt, gc, L, D),
                 "bf16": k1.s2d_conv_plain(x, kt, gc, L, D, bf16=True),
                 "db": k1.s2d_conv_plain(x, kt, gc, L, D),
                 "dt": k1.s2d_conv_plain(x, kt, gc, L, D),
                 "dt_bf16": k1.s2d_conv_plain(x, kt, gc, L, D, bf16=True)}
        for fold in (1, 4, 6):
            kof = torch.from_numpy(tfused.fold_s2d_kernel(k2, fold))
            for bf16 in (False, True):
                plain[f"of{fold}" + "_bf16" * bf16] = k1.s2d_conv_of_plain(
                    x, kof, gc, L, D, fold, bf16=bf16)
        before = dict(k1.LAUNCHES)
        for variant, want in plain.items():
            got = k1.pallas_s2d_conv(x, k2, gc, L, D, variant=variant)
            assert torch.equal(got, want), variant
        assert k1.LAUNCHES == before
        for variant in ("of7", "of0", "of4_f16", "ofx", "bf16h", "dma2",
                        "dt_f16"):
            with pytest.raises(ValueError):
                k1.pallas_s2d_conv(x, k2, gc, L, D, variant=variant)

    @pytest.mark.parametrize("variant,bound", [("dt", 4e-6),
                                               ("dt_bf16", 4e-3)])
    def test_dt_matches_jax_dt(self, variant, bound):
        """The port's pallas_s2d_conv(variant="dt" | "dt_bf16") (K4's
        plain version on the CPU) vs the JAX one in interpret mode and the
        XLA s2d conv, with the reference's bounds
        (test_pallas_kernels.py:99-117): f32 sum order for dt, bf16
        operand rounding for dt_bf16, x max of the f32 conv."""
        kernel, gc, _ = _kernel(16)
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        L = kernel.shape[-1]
        x = _noise(40_000, 0xD7)
        f32 = np.asarray(jfused._s2d_conv(jnp.asarray(x), k2, gc, L, D))
        want = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc, L, D,
                                          variant=variant))
        got = k1.pallas_s2d_conv(torch.from_numpy(x), k2, gc, L, D,
                                 variant=variant).numpy()
        assert got.shape == want.shape == f32.shape == (32, 4_000)
        scale = np.abs(f32).max()
        assert np.abs(got - f32).max() < bound * scale
        assert np.abs(got - want).max() < bound * scale

    def test_dt_refuses_a_window_over_shared_memory(self):
        """K4's f32 route keeps a tile's 2D x (256 + Lp - 1) window in
        shared memory: an input-channel count whose window does not fit
        is refused with a ValueError on every device (the reference fails
        there with an opaque pad error), and the bench's 20 channels fit.
        The bf16 route runs on the tensor-core kernel, which streams
        weights that do not fit a block: it takes the same shape (a block
        fits it) and on the CPU gives the plain bf16 conv."""
        k1.check_dt(20, 77)
        k1.check_dt(192, 40)
        decim = 120
        k2 = torch.zeros((2, 2 * decim, 3))
        x = torch.zeros(10_000, dtype=torch.complex64)
        with pytest.raises(ValueError, match="shared memory"):
            k1.s2d_conv_dt(x, k2, 0, 3 * decim, decim)
        with pytest.raises(ValueError, match="shared memory"):
            k1.pallas_s2d_conv(x, k2, 0, 3 * decim, decim, variant="dt")
        tc = k1.tc_pack_dt(k2)
        assert (k1.tc_smem_bytes(tc.ich, tc.packed.shape[1], tc.rows,
                                 tc.tile_m, tc.kchunk) <= k1.MAX_SMEM_BYTES)
        assert torch.equal(
            k1.pallas_s2d_conv(x, k2, 0, 3 * decim, decim, variant="dt_bf16"),
            k1.s2d_conv_plain(x, k2, 0, 3 * decim, decim, bf16=True))

    def test_wrapper_refuses_other_devices(self):
        kernel, gc, _ = _kernel(4)
        k2 = torch.from_numpy(tfused.s2d_kernel(kernel, D))
        x = torch.zeros(1000, dtype=torch.complex64, device="meta")
        with pytest.raises(ValueError):
            k1.s2d_conv(x, k2, gc, kernel.shape[-1], D)

    @pytest.mark.cuda
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("num_carriers,n", [(16, 100_003),
                                                (96, 40_007),
                                                ("pfb", 40_007)])
    def test_k1_matches_plain_on_card(self, cuda_device, num_carriers, n,
                                      bf16):
        """K1 vs the plain version on the card, TF32 off: f32 sum-order
        tolerance (the bf16 operands are rounded identically; bf16 runs
        the tensor-core route, counted as s2d_conv_bf16)."""
        kernel, gc, _ = _kernel(num_carriers)
        k2 = torch.as_tensor(tfused.s2d_kernel(kernel, D), device=cuda_device)
        x = torch.as_tensor(_noise(n, 7), device=cuda_device)
        name = "s2d_conv_bf16" if bf16 else "s2d_conv"
        before = k1.LAUNCHES[name]
        got = k1.s2d_conv(x, k2, gc, kernel.shape[-1], D, bf16=bf16)
        torch.cuda.synchronize()
        assert k1.LAUNCHES[name] == before + 1
        want = k1.s2d_conv_plain(x, k2, gc, kernel.shape[-1], D, bf16=bf16)
        assert got.shape == want.shape
        assert ((got - want).abs().max()
                <= 4e-6 * want.abs().max()).item()

    @pytest.mark.cuda
    @pytest.mark.parametrize("start", [0, 1], ids=["aligned", "offset"])
    @pytest.mark.parametrize("num_carriers,n", [(16, 100_003),
                                                ("pfb", 40_007)])
    def test_k3_bit_equal_to_k1_on_card(self, cuda_device, num_carriers, n,
                                        start):
        """K3 sums every output in K1's order: bit-equal to K1 f32, so
        within 4e-6 x max of the plain version.  The PFB kernel's pad_l =
        767 and an input starting one sample into its storage put the
        windows off the 16-byte grid of the async copies."""
        kernel, gc, _ = _kernel(num_carriers)
        L = kernel.shape[-1]
        k2 = torch.as_tensor(tfused.s2d_kernel(kernel, D), device=cuda_device)
        x = torch.as_tensor(_noise(n + start, 8), device=cuda_device)[start:]
        before = dict(k1.LAUNCHES)
        got = k1.s2d_conv_db(x, k2, gc, L, D)
        torch.cuda.synchronize()
        assert k1.LAUNCHES["s2d_conv_db"] == before["s2d_conv_db"] + 1
        assert torch.equal(got, k1.s2d_conv(x, k2, gc, L, D))
        want = k1.s2d_conv_plain(x, k2, gc, L, D)
        assert ((got - want).abs().max()
                <= 4e-6 * want.abs().max()).item()

    @pytest.mark.cuda
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("num_carriers,n", [(16, 100_003),
                                                (3, 40_007),
                                                ("pfb", 40_007),
                                                (16, 8_319_936),
                                                ("pfb", 1_000_007)])
    def test_k4_matches_plain_on_card(self, cuda_device, num_carriers, n,
                                      bf16):
        """K4 vs the plain version on the card, TF32 off: f32 sum-order
        tolerance (bf16 operands rounded identically); 3 carriers (C2 = 6)
        run on zero-padded weight rows, the filterbank on 6 row groups;
        the bench's n and the filterbank at a ragged n.  dt_bf16 runs the
        tensor-core kernel (counted as s2d_conv_dt_bf16), whose
        contraction depth 2D * Lp = 1540 keeps it within the same bound
        (the tc_tol of chip_smoke.py)."""
        kernel, gc, _ = _kernel(num_carriers)
        L = kernel.shape[-1]
        k2 = torch.as_tensor(tfused.s2d_kernel(kernel, D), device=cuda_device)
        x = torch.as_tensor(_noise(n, 10), device=cuda_device)
        name = "s2d_conv_dt_bf16" if bf16 else "s2d_conv_dt"
        before = dict(k1.LAUNCHES)
        got = k1.pallas_s2d_conv(x, k2, gc, L, D,
                                 variant="dt_bf16" if bf16 else "dt")
        torch.cuda.synchronize()
        assert k1.LAUNCHES[name] == before[name] + 1
        assert sum(k1.LAUNCHES.values()) == sum(before.values()) + 1
        want = k1.s2d_conv_plain(x, k2, gc, L, D, bf16=bf16)
        assert got.shape == want.shape
        tol = 4e-6 * max(1.0, k2.shape[1] * k2.shape[2] / 1600)
        assert ((got - want).abs().max()
                <= tol * want.abs().max()).item()

    @pytest.mark.cuda
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("fold", [1, 4, 6])
    def test_k1_of_matches_plain_on_card(self, cuda_device, fold, bf16):
        """K1-of vs the folded plain version: f32 sum-order tolerance
        (bf16 operands rounded identically on both sides; bf16 runs the
        tensor-core route, counted as s2d_conv_of_bf16)."""
        kernel, gc, _ = _kernel(16)
        L = kernel.shape[-1]
        k_of = torch.as_tensor(tfused.s2d_of_kernel(kernel, D, fold),
                               device=cuda_device)
        x = torch.as_tensor(_noise(100_007, 9), device=cuda_device)
        name = "s2d_conv_of_bf16" if bf16 else "s2d_conv_of"
        before = dict(k1.LAUNCHES)
        got = k1.s2d_conv_of(x, k_of, gc, L, D, fold, bf16=bf16)
        torch.cuda.synchronize()
        assert k1.LAUNCHES[name] == before[name] + 1
        want = k1.s2d_conv_of_plain(x, k_of, gc, L, D, fold, bf16=bf16)
        assert got.shape == want.shape == (32, 10_001)
        assert ((got - want).abs().max()
                <= 4e-6 * want.abs().max()).item()


# --- the op-level s2d channelizers ---------------------------------------

def _general_kernel(num_carriers):
    """A composite kernel on offsets off every rotation period (the f32
    residual-rotation path), with its rotation cycles."""
    offs = (jch.carrier_grid(num_carriers) + 1234.5678).astype(np.float64)
    kernel, gc, rot = jfused.fused_kernel(
        offs, CFG.sample_rate_hz, D, CFG.decim_fir_taps_per_phase,
        CFG.channel_fir_taps, CUTOFF)
    return np.asarray(kernel), gc, np.asarray(rot)


class TestOpLevelS2dChannelizers:
    """fused_channelize_s2d / _s2d_ri / _s2d_of_ri against the reference's
    functions of those names.  Tolerance: the s2d conv's f32 sum order,
    4e-6 x max|reference| (TestS2dConv); the rotation adds at most a few
    ulp (its grid table is the same f32 values, its f32 path the same
    reduced argument through cos / sin instead of exp)."""

    @pytest.mark.parametrize("rotate", [True, False])
    @pytest.mark.parametrize("grid", ["periodic", "general"])
    @pytest.mark.parametrize("num_carriers", [4, 16])
    def test_channelize_s2d(self, num_carriers, grid, rotate):
        kernel, gc, rot = (_kernel(num_carriers) if grid == "periodic"
                           else _general_kernel(num_carriers))
        assert (jfused._rotation_period(rot) > 0) == (grid == "periodic")
        L = kernel.shape[-1]
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        x = _noise(40_007, num_carriers)
        start = 1_000_003
        want = np.asarray(jfused.fused_channelize_s2d(
            jnp.asarray(x), k2, gc, L, rot, D, start_index=start,
            rotate=rotate))
        got = tfused.fused_channelize_s2d(torch.from_numpy(x), k2, gc, L,
                                          rot, D, start_index=start,
                                          rotate=rotate).numpy()
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape == (num_carriers, -(-40_007 // D))
        assert np.abs(got - want).max() < 4e-6 * np.abs(want).max()

    @pytest.mark.parametrize("num_carriers", [4, 16])
    def test_channelize_s2d_ri(self, num_carriers):
        kernel, gc, _ = _kernel(num_carriers)
        L = kernel.shape[-1]
        k2 = np.array(jfused.s2d_kernel(kernel, D))
        x = _noise(12_345, num_carriers + 1)
        want = jfused.fused_channelize_s2d_ri(jnp.asarray(x), k2, gc, L, D)
        got = tfused.fused_channelize_s2d_ri(torch.from_numpy(x),
                                             torch.from_numpy(k2), gc, L, D)
        scale = max(np.abs(np.asarray(w)).max() for w in want)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (num_carriers, -(-12_345 // D))
            assert np.abs(g.numpy() - np.asarray(w)).max() < 4e-6 * scale

    @pytest.mark.parametrize("fold", [2, 4])
    @pytest.mark.parametrize("num_carriers", [4, 16])
    def test_channelize_s2d_of_ri(self, num_carriers, fold):
        kernel, gc, _ = _kernel(num_carriers)
        L = kernel.shape[-1]
        k_of = np.array(jfused.s2d_of_kernel(kernel, D, fold))
        x = _noise(40_030, num_carriers + fold)
        want = jfused.fused_channelize_s2d_of_ri(jnp.asarray(x), k_of, gc, L,
                                                 D, fold)
        got = tfused.fused_channelize_s2d_of_ri(torch.from_numpy(x), k_of,
                                                gc, L, D, fold)
        scale = max(np.abs(np.asarray(w)).max() for w in want)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (num_carriers, 4_003)
            assert np.abs(g.numpy() - np.asarray(w)).max() < 4e-6 * scale

    @pytest.mark.parametrize("conv", ["s2d", "s2d_of"])
    def test_frontend_channelize_is_the_op(self, conv):
        """MulticarrierFrontend.channelize runs the op-level pair forms:
        the same values, bit for bit."""
        mc = tmc.MulticarrierFrontend.from_offsets(
            jch.carrier_grid(4), device="cpu", conv=conv)
        x = torch.from_numpy(_noise(20_000, 3))
        args = (mc.gc, mc.L, mc.decim)
        want = (k1.s2d_conv_plain(x, mc.kernel_s2d, *args) if conv == "s2d"
                else k1.s2d_conv_of_plain(x, mc.kernel_of, *args, mc.fold))
        got = torch.cat(mc.channelize(x))
        assert torch.equal(got, want)


# --- demod, sync, CRC: decisions are exact --------------------------------

class TestDemodOps:
    def test_quantize_z_ref_exact_on_sector_edges(self):
        """Exact: the same f32 comparisons, including z exactly on a
        sector edge (<= vs <) and z = 0 (bin 3)."""
        r = np.random.default_rng(11)
        base = r.standard_normal(64).astype(np.float32)
        t38 = np.float32(1.0 + np.sqrt(2.0))
        t18 = np.float32(np.sqrt(2.0) - 1.0)
        zr = [np.float32(0.0), base, -base, base, np.abs(base),
              np.abs(base) * t18, -np.abs(base) * t18, np.zeros(8, np.float32),
              r.standard_normal(500).astype(np.float32)]
        zi = [np.float32(0.0), np.zeros_like(base), base, base * t38,
              -np.abs(base) * t38, np.abs(base), -np.abs(base),
              r.standard_normal(8).astype(np.float32),
              r.standard_normal(500).astype(np.float32)]
        zr = np.concatenate([np.atleast_1d(v) for v in zr]).astype(np.float32)
        zi = np.concatenate([np.atleast_1d(v) for v in zi]).astype(np.float32)
        want = np.asarray(jdq.quantize_z_ref(jnp.asarray(zr), jnp.asarray(zi)))
        got = tdq.quantize_z_ref(torch.from_numpy(zr),
                                 torch.from_numpy(zi)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert got[0] == 3                       # z = 0
        assert set(np.unique(got)) == {0, 1, 2, 3}

    def test_quantize_phase_alias_exact(self):
        """quantize_phase is the reference-bins quantizer, as in the
        reference: equal on a seeded phase grid and on every bin edge."""
        assert tdq.quantize_phase is tdq.quantize_phase_ref
        r = np.random.default_rng(13)
        edges = np.float32([np.pi / 8 * k for k in (-5, -3, 3, 5)])
        dphi = np.concatenate([
            np.linspace(-np.pi, np.pi, 4097, dtype=np.float32), edges,
            np.nextafter(edges, np.float32(0)),
            np.nextafter(edges, np.float32(np.inf)),
            r.uniform(-4, 4, 1000).astype(np.float32)])
        want = np.asarray(jdq.quantize_phase(jnp.asarray(dphi)))
        got = tdq.quantize_phase(torch.from_numpy(dphi)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) == {0, 1, 2, 3}

    def test_symbols_to_bits_exact(self):
        s = np.random.default_rng(12).integers(0, 8, (3, 50)).astype(np.uint8)
        np.testing.assert_array_equal(
            tdq.symbols_to_bits(torch.from_numpy(s)).numpy(),
            np.asarray(jdq.symbols_to_bits(jnp.asarray(s))))

    def test_sync_correlation_exact(self):
        """Sums of ±1 are integers <= 22: exact in f32 on both sides."""
        bits = np.random.default_rng(13).integers(0, 2, (4, 600)
                                                  ).astype(np.uint8)
        bits[1, 100:122] = C.TS1
        bits[2, 300:322] = C.TS2
        np.testing.assert_array_equal(
            tsync.sync_correlation(torch.from_numpy(bits)).numpy(),
            np.asarray(jsync.sync_correlation(jnp.asarray(bits))))
        got = tsync.best_correlation(torch.from_numpy(bits)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jsync.best_correlation(jnp.asarray(bits))))
        assert got[1, 100] == 1.0 and got[2, 300] == 1.0
        assert tsync.best_correlation(torch.zeros(2, 10)).shape == (2, 0)

    def _frames(self):
        """Golden MAC-RESOURCE data regions with 0..4 flipped bits, their
        reversed-payload twins, and the all-0/all-1 degenerate frames."""
        r = np.random.default_rng(14)
        rows = []
        for i in range(6):
            slot = synth.make_mac_resource_frame_bits(b"PARITY %d" % i,
                                                      seed=40 + i)
            data = np.concatenate([slot[:108], slot[122:230]])
            for flips in range(5):
                d = data.copy()
                d[r.choice(216, flips, replace=False)] ^= 1
                rows.append(d)
            rev = data.copy()
            rev[:200] = rev[:200][::-1]
            rows.append(rev)
        rows += [np.zeros(216, np.uint8), np.ones(216, np.uint8),
                 r.integers(0, 2, 216).astype(np.uint8)]
        return np.stack(rows).astype(np.uint8)

    def test_soft_crc_exact(self):
        frames = self._frames()
        a, c0 = tcrc.crc_tables(200, "cpu")
        got = tcrc.soft_crc_check_batch(torch.from_numpy(frames), a, c0
                                        ).numpy()
        want = np.asarray(jcrc.soft_crc_check_batch(jnp.asarray(frames)))
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
        np.testing.assert_array_equal(
            tcrc.crc16_batch(torch.from_numpy(frames[:, :200]), a, c0).numpy(),
            np.asarray(jcrc.crc16_batch(jnp.asarray(frames[:, :200]))))
        for f in frames:
            assert tcrc.soft_crc_check_host(f) == jcrc.soft_crc_check_host(f)


class TestDemodFromPair:
    @pytest.mark.parametrize("rotate", [False, True])
    def test_matches_reference(self, rotate):
        """Identical f32 inputs: bits, count and best phase exact;
        sync_corr < 1e-6 (it derives from the bits)."""
        r = np.random.default_rng(15 + rotate)
        sps = CFG.ref_samples_per_symbol
        m = sps * 700 + 9
        yr = r.standard_normal((5, m)).astype(np.float32)
        yi = r.standard_normal((5, m)).astype(np.float32)
        z_rot = None
        if rotate:
            z_rot = tfused.symbol_rotation(
                tch.carrier_grid(5) / CFG.sample_rate_hz, D, sps)
        want = jrp._demod_from_pair(jnp.asarray(yr), jnp.asarray(yi), sps,
                                    z_rot=z_rot)
        got = trp._demod_from_pair(
            torch.from_numpy(yr), torch.from_numpy(yi), sps,
            z_rot=None if z_rot is None else tuple(map(torch.from_numpy,
                                                       z_rot)))
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        np.testing.assert_array_equal(got.best_phase.numpy(),
                                      np.asarray(want.best_phase))
        assert np.abs(got.sync_corr.numpy()
                      - np.asarray(want.sync_corr)).max() < 1e-6


class TestExtractCandidates:
    @pytest.mark.parametrize("b,k", [(3_000, 16), (20_000, 8)],
                             ids=["plain_topk", "hierarchical"])
    def test_exact_with_ties(self, b, k):
        """Correlations quantised to j/22 make ties common; ties go to the
        lower index as in lax.top_k.  Everything exact."""
        r = np.random.default_rng(b + k)
        bits = r.integers(0, 2, (3, b)).astype(np.uint8)
        bits[0, 700:1210] = synth.make_mac_resource_frame_bits(b"TIE", seed=5)
        corr = (r.integers(0, 23, (3, b - 21)) / 22).astype(np.float32)
        valid_bits = np.array([b, b - 700, 900], np.int32)
        n_seg = -(-(b - 21) // 128)
        assert (n_seg < 4 * k) == (b == 3_000)
        want = jmc.extract_candidates(jnp.asarray(bits), jnp.asarray(corr),
                                      jnp.asarray(valid_bits), k, 0.80)
        a, c0 = tcrc.crc_tables(200, "cpu")
        got = tmc.extract_candidates(
            torch.from_numpy(bits), torch.from_numpy(corr),
            torch.from_numpy(valid_bits), k, 0.80, a, c0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[2].any()
