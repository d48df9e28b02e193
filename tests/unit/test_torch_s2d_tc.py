"""The tensor-core route of K1 / K1-of (csrc/s2d_conv_tc.cu): its weight
packing, its block shapes and its index map on the CPU, against the JAX
package's Pallas kernel in interpret mode; the kernel itself against its
plain version on the card (`cuda`-marked), at 2.4 MS/s and at rates
whose 2D is not a multiple of 4 or whose weights stream through shared
memory.  Both sides multiply the same bf16 operands and sum in f32, so
every comparison holds the f32 sum-order bound, 4e-6 x max|plain|, up
to the main path's contraction depth; `_tol` scales it with deeper
ones."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.ops import channelizer as jch
from tetraear_tpu.ops import fused as jfused
from tetraear_tpu.ops.pallas.s2d_conv import pallas_s2d_conv

from tetraear_tpu_torch.config import ReceiverConfig as TReceiverConfig
from tetraear_tpu_torch.models.multicarrier import (MulticarrierFrontend,
                                                    PfbMulticarrierFrontend)
from tetraear_tpu_torch.ops import fused as tfused
from tetraear_tpu_torch.ops.kernels import s2d_conv as k1

# Rates (MS/s) and what each exercises: 2.4 the main path; 8 (2D = 66,
# K = 5082) 4-byte A loads and weights streamed in chunks; 1.8 and 3.2
# (odd D) 4-byte A loads, resident weights; 20 (2D = 166) a window too
# large for the register prefetch.
TOL = 4e-6


def _tol(k2: np.ndarray) -> float:
    """The kernel's bound against its plain version for s2d weights k2:
    TOL up to K = 2D * Lp = 1600 (the main path's depth: 1540 measured at
    3.5e-6 x max), then TOL * K / 1600 -- each of the K / 16 MMA steps
    truncates its f32 sum, a bias that adds up with depth (16 carriers
    at 8 MS/s, K = 5082: 8.05e-6 x max measured on an H100)."""
    return TOL * max(1.0, k2.shape[1] * k2.shape[2] / 1600)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda:0")


def _cfg(msps: float) -> ReceiverConfig:
    return ReceiverConfig(sample_rate_hz=msps * 1e6)


def _kernel(num_carriers, msps: float = 2.4):
    """(s2d kernel, gc, L, D): carrier_grid(num_carriers)'s composite
    kernel at `msps` MS/s, or the full-band filterbank's (gc = 0, fs /
    25 kHz channels) for "pfb"."""
    cfg = _cfg(msps)
    decim = cfg.decimation_factor
    if num_carriers == "pfb":
        kernel, gc, _ = jfused.pfb_kernel(int(round(msps * 1e6 / 25e3)),
                                          cfg.sample_rate_hz)
    else:
        cutoff = ((cfg.channel_bandwidth_hz / 2)
                  / (cfg.intermediate_rate_hz / 2))
        offs = jch.carrier_grid(num_carriers).astype(np.float64)
        kernel, gc, _ = jfused.fused_kernel(
            offs, cfg.sample_rate_hz, decim, cfg.decim_fir_taps_per_phase,
            cfg.channel_fir_taps, cutoff)
    kernel = np.asarray(kernel)
    return (np.array(jfused.s2d_kernel(kernel, decim)), gc, kernel.shape[-1],
            decim)


def _noise(n, seed):
    r = np.random.default_rng(seed)
    return ((r.standard_normal(n) + 1j * r.standard_normal(n)) * 0.1
            ).astype(np.complex64)


def _weights(k2: np.ndarray, fold: int) -> torch.Tensor:
    """K1's weights (fold 1) or the output-folded kernel of fold F."""
    if fold == 1:
        return torch.from_numpy(k2)
    return torch.from_numpy(tfused.fold_s2d_kernel(k2, fold))


def _pack(k2: np.ndarray, fold) -> k1.TcWeights:
    """What the bf16 wrappers launch: K1's weights ("k1", as its
    tc_k1_fold), K4's ("dt", unfolded) or the output-folded kernel of
    `fold`."""
    if fold == "k1":
        return k1.tc_pack_k1(torch.from_numpy(k2))
    if fold == "dt":
        return k1.tc_pack_dt(torch.from_numpy(k2))
    return k1.tc_pack(_weights(k2, fold), fold)


def _unpack(tc: k1.TcWeights, nrows: int, kdim: int) -> torch.Tensor:
    """tc_pack inverted to the (nrows, kdim) f32 matrix B^T, k = a * ich
    + i (kdim up to the padded KS * 16, whose tail is 0)."""
    groups, ksteps, _, octets = tc.packed.shape[:4]
    b = tc.packed.permute(0, 3, 4, 1, 2, 5).reshape(groups * octets * 8,
                                                     ksteps, k1.TC_KSTEP)
    inv = [0] * k1.TC_KSTEP
    for kk, k in enumerate(k1.TC_KPERM):
        inv[k] = kk
    b = b[:, :, inv].reshape(groups * octets * 8, ksteps * k1.TC_KSTEP)
    return b[:nrows, :kdim].float()


def _emulate(x: torch.Tensor, tc: k1.TcWeights, gc: int, L: int,
             decim: int) -> torch.Tensor:
    """The kernel's index map in plain PyTorch: the stream s (x's floats
    after 2(L-1-gc) zeros) rounded to bf16, its Hankel view A[w, k] =
    s[w * ich + k] (as_strided), A @ B for the unpacked weights, and the
    un-fold of kernel row c*F + f at folded position w into out[c, w*F +
    f].  -> (C2, ceil(N/D)) f32."""
    n = x.shape[-1]
    m_out = -(-n // decim)
    m_pos = -(-m_out // tc.fold)
    kp = tc.packed.shape[1] * k1.TC_KSTEP
    pad = 2 * (L - 1 - gc)
    s = torch.zeros(max((m_pos - 1) * tc.ich + kp, pad + 2 * n))
    s[pad:pad + 2 * n] = torch.view_as_real(x).reshape(-1)
    a = s.to(torch.bfloat16).float().as_strided((m_pos, kp), (tc.ich, 1))
    y = a @ _unpack(tc, tc.c2, kp).t()                 # (m_pos, C2 * F)
    c2 = tc.c2 // tc.fold
    out = y.t().reshape(c2, tc.fold, m_pos).transpose(1, 2)
    return out.reshape(c2, m_pos * tc.fold)[:, :m_out]


class TestPacking:
    @pytest.mark.parametrize("num_carriers,fold,msps", [
        (16, "k1", 2.4), ("pfb", "k1", 2.4), (16, 4, 2.4), (16, 6, 2.4),
        (16, "k1", 8.0), ("pfb", "k1", 1.8), (16, "dt", 2.4),
        ("pfb", "dt", 2.4)])
    def test_unpack_inverts_pack(self, num_carriers, fold, msps):
        """unpack(pack(K)) is K's (rows, K) matrix rounded to bf16, with k =
        a * ich + i, for K1 at C2 = 32 (as its fold of 4) and 192, K4's
        unfolded weights at both, the folded kernels, 16 carriers at 8
        MS/s and the odd-D full band; the padded tail of K and of the last
        row group is zero."""
        k2, _, _, _ = _kernel(num_carriers, msps)
        tc = _pack(k2, fold)
        f = tc.fold
        weights = (torch.from_numpy(tfused.fold_s2d_kernel(k2, f))
                   if f > 1 else torch.from_numpy(k2))
        kf = k1.fold_channels(weights, f)
        nrows, ich, taps = kf.shape
        assert (tc.c2, tc.ich) == (nrows, ich)
        groups, ksteps = -(-nrows // tc.rows), -(-ich * taps // 32) * 2
        assert tc.packed.shape == (groups, ksteps, 2, tc.rows // 8, 8, 8)
        assert tc.packed.dtype == torch.bfloat16
        want = kf.permute(0, 2, 1).reshape(nrows, ich * taps)
        assert torch.equal(_unpack(tc, nrows, ich * taps),
                           want.to(torch.bfloat16).float())
        full = _unpack(tc, groups * tc.rows, ksteps * 16)
        assert not full[nrows:].any() and not full[:, ich * taps:].any()

    @pytest.mark.parametrize("rows", [32, 64])
    def test_core_matrix_order(self, rows):
        """k-step ks is wgmma's no-swizzle K-major tile: core matrix (kc,
        nc) holds kernel rows 8 nc + r (r < 8) at MMA columns 8 kc + j
        (j < 8), 16 bytes per row, so B's descriptor takes rows x 16 bytes
        between the k halves and 128 between row octets; MMA column kk is
        k = 16 ks + TC_KPERM[kk], which puts columns 2t, 2t+1, 2t+8, 2t+9
        on stream offsets 4t .. 4t + 3."""
        assert sorted(k1.TC_KPERM) == list(range(16))
        for t in range(4):
            assert [k1.TC_KPERM[c] for c in (2 * t, 2 * t + 1, 2 * t + 8,
                                             2 * t + 9)] == [4 * t + i
                                                             for i in range(4)]
        kdim = 48
        # each entry its row index, then its k: small integers, exact in
        # bf16, so the two together pin every position
        by_row = torch.arange(rows, dtype=torch.float32)[:, None].expand(
            rows, kdim)
        by_k = torch.arange(kdim, dtype=torch.float32)[None, :].expand(
            rows, kdim)
        for b in (by_row, by_k):
            packed = k1.pack_tc_weights(b.reshape(rows, kdim, 1),
                                        rows).float()
            assert packed.shape == (1, 4, 2, rows // 8, 8, 8)
            flat = packed.reshape(-1)
            for ks, kc, nc, r, j in ((0, 0, 0, 0, 0), (1, 1, 3, 7, 5),
                                     (2, 0, 2, 4, 7)):
                byte = (32 * rows * ks + 16 * rows * kc + 128 * nc + 16 * r
                        + 2 * j)
                k = 16 * ks + k1.TC_KPERM[8 * kc + j]
                assert flat[byte // 2] == b[8 * nc + r, k]
            assert not packed[0, 3].any()          # the padded 4th k-step

    def test_fold_channels_regroups_the_taps(self):
        """fold_channels regroups an output-folded kernel's taps into
        2D * F channels: K3f[cf, f*2D + i, af] = K_of[cf, i, af*F + f]."""
        k2, _, _, _ = _kernel(4)
        k_of = _weights(k2, 4)
        kf = k1.fold_channels(k_of, 4)
        assert kf.shape == (32, 80, 20)
        for cf, f, i, af in ((0, 0, 0, 0), (5, 3, 19, 19), (31, 2, 7, 4)):
            a = af * 4 + f
            want = k_of[cf, i, a] if a < k_of.shape[-1] else 0.0
            assert kf[cf, f * 20 + i, af] == want
        assert torch.equal(k1.fold_channels(k_of, 1), k_of)


# Planted decodes beyond the contraction depth K = 2D * Lp = 1600 up to
# which the route holds the f32 sum-order bound: 16 carriers at 8 MS/s
# (K = 5082), the full band at 3.2 MS/s (K = 2054) and 16 carriers at 20
# MS/s (K = 12782)
DECISION_RATES = [(16, 8.0), ("pfb", 3.2), (16, 20.0)]


def _planted_frontend(kind, msps: float, device):
    """(the `pallas_bf16` frontend at `msps` MS/s, its planted signal,
    {row: planted text}): texts on grid indices 3, 8 and 12 of
    carrier_grid(16), or on three channels of the full band."""
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    from tetraear_tpu_torch.utils.synth import planted_pfb, planted_wideband
    cfg = TReceiverConfig(sample_rate_hz=msps * 1e6)
    if kind == "pfb":
        x, want = planted_pfb(sample_rate_hz=cfg.sample_rate_hz)
        fe = PfbMulticarrierFrontend.from_config(cfg, device=device,
                                                 conv="pallas_bf16")
    else:
        x, want = planted_wideband((3, 8, 12),
                                   sample_rate_hz=cfg.sample_rate_hz)
        fe = MulticarrierFrontend.from_offsets(carrier_grid(16), cfg,
                                               device=device,
                                               conv="pallas_bf16")
    return fe, x, want


class TestDecisionsAtOtherRates:
    @pytest.mark.parametrize("kind,msps", DECISION_RATES)
    def test_planted_signal_decodes(self, kind, msps):
        """On the CPU (the plain bf16 conv), each rate's planted signal
        decodes every text on its row with a CRC-ok candidate: the
        signal the card's decision check compares on."""
        from tetraear_tpu_torch.models.multicarrier import MulticarrierDecoder
        fe, x, want = _planted_frontend(kind, msps, "cpu")
        assert fe.kernel_s2d.shape[1] * fe.kernel_s2d.shape[2] > 1600
        res = fe(x)
        frames = MulticarrierDecoder(res.bits.shape[0],
                                     device="cpu").decode(res)
        for row, text in want.items():
            assert text in {f.get("sds_message") for f in frames[row]}
            assert (res.crc_ok & res.cand_valid)[row].any()


def _banks(ich: int, step: int, c0: int) -> list:
    """Banks of one half warp's 8-byte A-fragment loads (rows g of an m16
    slab, lanes t = 0..3, two words each) at window word offset c0."""
    words = ich // 2
    return [[((step * g) * words + c0 + 2 * t + w) % 32
             for g in half for t in range(4) for w in (0, 1)]
            for half in (range(4), range(4, 8))]


class TestLayout:
    @pytest.mark.parametrize("ich", [20, 40, 60, 80, 100, 120])
    def test_a_loads_avoid_bank_conflicts(self, ich):
        """With the row step tc_row_step picks, each half warp's 8-byte
        A-fragment load hits 32 distinct banks, for the un-folded input
        and every fold up to 6 (the rows g + 8 add a constant)."""
        step = k1.tc_row_step(ich)
        for c0 in (0, 8, 16, 392):
            for banks in _banks(ich, step, c0):
                assert len(set(banks)) == 32, (ich, step, c0)

    def test_configs_of_the_shapes_in_use(self):
        """64 kernel rows a block (m64n64k16) for K1 (C2 = 32 as its fold
        of 4, so K1-of's shape), the full band and folds up to 4, 32 for
        folds 5 and 6, all with the weights resident; each fits one
        block's shared memory."""
        assert k1.tc_k1_fold(32, 20, 77) == 4
        assert k1.tc_k1_fold(192, 20, 77) == 1
        for ich, ksteps, want in (
                (40, 98, (64, 256, 98)), (20, 98, (64, 256, 98)),
                (80, 100, (64, 128, 100)), (60, 102, (64, 128, 102)),
                (100, 108, (32, 128, 108)), (120, 106, (32, 128, 106))):
            assert k1.tc_config(ich, ksteps) == want
            assert k1.tc_smem_bytes(ich, ksteps, *want) <= k1.MAX_SMEM_BYTES
        assert k1.tc_smem_bytes(40, 98, 64, 256, 98) == 225_088

    def test_k4_runs_unfolded(self):
        """K4's bf16 route packs the 16-carrier weights unfolded (C2 = 32
        rows, K = 2D * Lp = 1540 in 98 k-steps, tap-major) into one block
        of 64 rows, half of them zero, that holds all the weights (256
        positions a tile); the full band's 192 rows take three blocks."""
        k2, _, _, _ = _kernel(16)
        tc = k1.tc_pack_dt(torch.from_numpy(k2))
        assert (tc.c2, tc.ich, tc.fold) == (32, 20, 1)
        assert (tc.rows, tc.tile_m, tc.kchunk) == (64, 256, 98)
        assert tc.packed.shape == (1, 98, 2, 8, 8, 8)
        kp, _, _, _ = _kernel("pfb")
        tcp = k1.tc_pack_dt(torch.from_numpy(kp))
        assert (tcp.c2, tcp.fold, tcp.rows, tcp.packed.shape[0]) == (
            192, 1, 64, 3)

    def test_weights_stream_where_they_do_not_fit(self):
        """Where no block holds a row group's weights (16 carriers at 8
        MS/s: 2D = 66, K = 5082), 64 rows stream them through shared
        memory in the largest even chunk beside the window; a window that
        leaves no room for two k-steps is refused."""
        rows, tile_m, kchunk = k1.tc_config(66, 318)
        assert (rows, tile_m) == (64, 256) and kchunk % 2 == 0
        assert 2 <= kchunk < 318
        assert (k1.tc_smem_bytes(66, 318, rows, tile_m, kchunk)
                <= k1.MAX_SMEM_BYTES
                < k1.tc_smem_bytes(66, 318, rows, tile_m, kchunk + 2))
        with pytest.raises(ValueError, match="shared memory"):
            k1.tc_config(1800, 4000)

    @pytest.mark.parametrize("msps", [1.0, 1.8, 2.4, 3.2, 5.0, 6.0, 8.0,
                                      12.0, 20.0])
    def test_every_rate_has_a_block(self, msps):
        """The 16-carrier and full-band weights of each rate pack into a
        block that fits (the CUDA-core kernel this route replaced took
        any of them): 2D = 2 mod 4 takes 4-byte A loads, weights too
        large for a block stream through it."""
        cfg = TReceiverConfig(sample_rate_hz=msps * 1e6)
        offs = np.arange(16) * 25e3 - 187.5e3
        for fe in (MulticarrierFrontend.from_offsets(offs, cfg, device="cpu"),
                   PfbMulticarrierFrontend.from_config(cfg, device="cpu")):
            tc = k1.tc_pack_k1(fe.kernel_s2d)
            ksteps = tc.packed.shape[1]
            assert (k1.tc_smem_bytes(tc.ich, ksteps, tc.rows, tc.tile_m,
                                     tc.kchunk)
                    <= k1.MAX_SMEM_BYTES)
            assert tc.ich % 2 == 0 and ksteps % 2 == tc.kchunk % 2 == 0


class TestEmulation:
    @pytest.mark.parametrize("variant,fold,n,msps", [
        ("bf16", "k1", 40_000, 2.4), ("bf16", "k1", 12_345, 2.4),
        ("of4_bf16", 4, 40_007, 2.4), ("of1_bf16", "k1", 30_011, 8.0),
        ("of3_bf16", 3, 20_003, 1.8), ("dt_bf16", "dt", 40_003, 2.4)])
    def test_index_map_matches_pallas(self, variant, fold, n, msps):
        """The kernel's index map as the wrapper launches it (the Hankel
        view of the bf16-rounded stream times the packed weights,
        un-folded; K1 as its tc_k1_fold, K4's dt_bf16 unfolded) vs the
        JAX package's
        pallas_s2d_conv in interpret mode: both multiply the same bf16
        operands and sum in f32, so only the sum order differs (the f32
        sum-order bound, 4e-6 x max).  At 8 MS/s (2D = 66, over the
        reference K1's 24 channels) K1's route runs fold 1, which is the
        reference's K1-of at fold 1."""
        k2, gc, L, decim = _kernel(16, msps)
        x = _noise(n, 0x7C ^ n)
        want = np.asarray(pallas_s2d_conv(jnp.asarray(x), k2, gc, L, decim,
                                          variant=variant))
        got = _emulate(torch.from_numpy(x), _pack(k2, fold), gc, L,
                       decim).numpy()
        assert got.shape == want.shape == (32, -(-n // decim))
        assert np.abs(got - want).max() < TOL * np.abs(want).max()

    @pytest.mark.parametrize("msps,groups", [(2.4, 3), (3.2, 8)])
    def test_index_map_on_the_filterbank(self, msps, groups):
        """The full band (C2 = 192 in three row groups of 64; at 3.2 MS/s
        C2 = 256 with D = 13 in eight of 32), gc = 0 (the left zero pad
        covers the first Lp windows): the emulation equals the plain bf16
        conv within the f32 sum-order bound."""
        k2, gc, L, decim = _kernel("pfb", msps)
        kernel = torch.from_numpy(k2)
        tc = k1.tc_pack_k1(kernel)
        assert tc.fold == 1 and tc.packed.shape[0] == groups
        x = torch.from_numpy(_noise(5_003, 0x192))
        got = _emulate(x, tc, gc, L, decim)
        want = k1.s2d_conv_plain(x, kernel, gc, L, decim, bf16=True)
        assert got.shape == want.shape == (k2.shape[0], -(-5_003 // decim))
        assert ((got - want).abs().max() < TOL * want.abs().max()).item()

    def test_cpu_tensors_take_the_plain_version(self):
        """On CPU tensors the bf16 wrappers run the plain versions and
        count no launch of the tensor-core route."""
        k2, gc, L, decim = _kernel(4)
        x = torch.from_numpy(_noise(3_001, 4))
        before = dict(k1.LAUNCHES)
        assert torch.equal(
            k1.s2d_conv(x, torch.from_numpy(k2), gc, L, decim, bf16=True),
            k1.s2d_conv_plain(x, torch.from_numpy(k2), gc, L, decim,
                              bf16=True))
        k_of = _weights(k2, 4)
        assert torch.equal(
            k1.s2d_conv_of(x, k_of, gc, L, decim, 4, bf16=True),
            k1.s2d_conv_of_plain(x, k_of, gc, L, decim, 4, bf16=True))
        assert k1.LAUNCHES == before

    def test_frontends_pack_only_on_a_card(self):
        """A CPU frontend holds no packed weights (its conv is the plain
        version); the wrappers take packed weights only on a card."""
        fe = MulticarrierFrontend.from_offsets(np.arange(16) * 25e3,
                                               device="cpu")
        assert fe.bf16 and fe.tc is None
        assert "kernel_tc" not in dict(fe.named_buffers())


@pytest.mark.cuda
class TestOnCard:
    """The kernel against its plain version (TF32 off: the plain bf16
    conv multiplies the same rounded operands and sums in f32) within
    _tol x max|plain|, and against the f32 conv within the bf16 bound."""

    @pytest.fixture(autouse=True)
    def _no_tf32(self):
        old = (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old

    @pytest.mark.parametrize("num_carriers,n,start,msps", [
        (16, 8_319_936, 0, 2.4), (16, 1_000_007, 0, 2.4),
        (16, 1_000_007, 1, 2.4), ("pfb", 1_000_007, 0, 2.4),
        ("pfb", 40_007, 1, 2.4), (16, 1_000_007, 1, 8.0),
        ("pfb", 300_007, 0, 3.2), ("pfb", 100_003, 1, 1.8),
        (16, 400_009, 0, 20.0)])
    def test_k1_bf16(self, cuda_device, num_carriers, n, start, msps):
        k2, gc, L, decim = _kernel(num_carriers, msps)
        kt = torch.as_tensor(k2, device=cuda_device)
        x = torch.as_tensor(_noise(n + start, 11), device=cuda_device)[start:]
        before = dict(k1.LAUNCHES)
        got = k1.s2d_conv(x, kt, gc, L, decim, bf16=True)
        torch.cuda.synchronize()
        assert k1.LAUNCHES["s2d_conv_bf16"] == before["s2d_conv_bf16"] + 1
        assert k1.LAUNCHES["s2d_conv"] == before["s2d_conv"]
        want = k1.s2d_conv_plain(x, kt, gc, L, decim, bf16=True)
        assert got.shape == want.shape
        assert ((got - want).abs().max()
                <= _tol(k2) * want.abs().max()).item()
        f32 = k1.s2d_conv_plain(x, kt, gc, L, decim)
        assert ((got - f32).abs().max() <= 1e-2 * f32.abs().max()).item()

    @pytest.mark.parametrize("fold,n,msps", [
        (4, 8_319_936, 2.4), (6, 1_000_007, 2.4), (1, 1_000_007, 2.4),
        (2, 100_003, 2.4), (3, 100_003, 2.4), (5, 100_003, 2.4),
        (3, 100_003, 1.8), (1, 100_003, 8.0)])
    def test_k1_of_bf16(self, cuda_device, fold, n, msps):
        k2, gc, L, decim = _kernel(16, msps)
        k_of = _weights(k2, fold).to(cuda_device)
        x = torch.as_tensor(_noise(n, 12), device=cuda_device)
        before = dict(k1.LAUNCHES)
        got = k1.s2d_conv_of(x, k_of, gc, L, decim, fold, bf16=True)
        torch.cuda.synchronize()
        assert (k1.LAUNCHES["s2d_conv_of_bf16"]
                == before["s2d_conv_of_bf16"] + 1)
        want = k1.s2d_conv_of_plain(x, k_of, gc, L, decim, fold, bf16=True)
        assert got.shape == want.shape == (32, -(-n // decim))
        assert ((got - want).abs().max()
                <= _tol(k2) * want.abs().max()).item()

    @pytest.mark.parametrize("msps,pfb", [(8.0, False), (3.2, True)])
    def test_frontend_at_another_rate(self, cuda_device, msps, pfb):
        """The `pallas_bf16` frontend at 8 MS/s (16 carriers) and at
        3.2 MS/s (full band, D = 13) packs its weights once and channelizes
        as the plain bf16 conv does."""
        cfg = TReceiverConfig(sample_rate_hz=msps * 1e6)
        fe = (PfbMulticarrierFrontend.from_config(cfg, device=cuda_device)
              if pfb else MulticarrierFrontend.from_offsets(
                  np.arange(16) * 25e3 - 187.5e3, cfg, device=cuda_device))
        assert fe.tc is not None and fe.kernel_tc.is_cuda
        x = torch.as_tensor(_noise(500_011, 14), device=cuda_device)
        before = k1.LAUNCHES["s2d_conv_bf16"]
        yr, yi = fe.channelize(x)
        torch.cuda.synchronize()
        assert k1.LAUNCHES["s2d_conv_bf16"] == before + 1
        want = k1.s2d_conv_plain(x, fe.kernel_s2d, fe.gc, fe.L, fe.decim,
                                 bf16=True)
        got = torch.cat([yr, yi])
        assert ((got - want).abs().max()
                <= _tol(fe.kernel_s2d) * want.abs().max()).item()

    @pytest.mark.parametrize("kind,msps", DECISION_RATES)
    def test_candidates_equal_the_plain_bf16_conv(self, cuda_device, kind,
                                                  msps):
        """Beyond K = 1600, where the route is held to _tol only, its
        decisions on the planted rows equal those of the same frontend
        with the plain bf16 conv: validity, positions, frame bits and CRC
        verdicts, with a CRC-ok candidate on every planted row."""
        fe, x, want = _planted_frontend(kind, msps, cuda_device)
        x = torch.as_tensor(x, device=cuda_device)
        before = k1.LAUNCHES["s2d_conv_bf16"]
        got = fe(x)
        torch.cuda.synchronize()
        assert k1.LAUNCHES["s2d_conv_bf16"] == before + 1
        out = k1.s2d_conv_plain(x, fe.kernel_s2d, fe.gc, fe.L, fe.decim,
                                bf16=True)
        c = out.shape[0] // 2
        plain = fe.candidates(*fe.demod((out[:c], out[c:])))
        fields = ("cand_valid", "cand_pos", "frame_bits", "crc_ok")
        a = {f: getattr(got, f).cpu().numpy() for f in fields}
        b = {f: getattr(plain, f).cpu().numpy() for f in fields}
        for row in want:
            va, vb = a["cand_valid"][row], b["cand_valid"][row]
            np.testing.assert_array_equal(va, vb)
            for f in fields[1:]:
                np.testing.assert_array_equal(a[f][row][va], b[f][row][vb])
            assert (a["crc_ok"][row] & va).any()
