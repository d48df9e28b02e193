"""Multicarrier full decode (BASELINE config 4) and the full-band PFB
decode, port of `tetraear_tpu.models.multicarrier`: one wideband IQ
block -> per-carrier bits, dense sync scores and fixed-K frame candidates
with soft-CRC verdicts, with only MAC/SDS parsing left to the host.

Every frontend here runs `CandidateStage.forward`: the chunk copy, its
own `channelize` and `demod`, the candidates stage.
`MulticarrierFrontend` convolves with the composite s2d kernel (mixer +
decimating FIR + channel FIR) by the conv its CONV_VARIANTS entry names,
then runs the real-pair tail (or for "fused" the complex demod front);
`PfbMulticarrierFrontend` does so over all 96 channels of the 25 kHz
grid at 2.4 MS/s with the filterbank as one dense conv (192 rows).  The
staged chains, the reference's `fused=False`, are
`StagedMulticarrierFrontend` (K5 on the card, then the channel FIR) and
`GatherPfbFrontend` (the gather-form filterbank), then `_demod_front`.
`conv_variant` is the one parse and check of a conv name, and
`build_frontend` makes the frontend that runs it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.core.decoder import (SlotWalk, TetraDecoder,
                                             decode_walks)
from tetraear_tpu_torch.models.candidates import (  # noqa: F401
    CandidateStage, MulticarrierResult, candidate_stage, extract_candidates)
from tetraear_tpu_torch.models.realpair import (
    StagedState, _demod_from_pair, staged_state)
from tetraear_tpu_torch.ops import dqpsk, fused, pfb, sync
from tetraear_tpu_torch.ops.channelizer import channelize
from tetraear_tpu_torch.ops.fir import fir_filter_same
from tetraear_tpu_torch.ops.kernels.s2d_conv import (
    check_fold, parse_fold, s2d_conv, s2d_conv_db, s2d_conv_of, tc_pack,
    tc_pack_k1)
from tetraear_tpu_torch.ops.timing import best_phase_pick
from tetraear_tpu_torch.utils.metrics import record, span, tracing


def _demod_front(y: torch.Tensor, sps: int,
                 z_rot: tuple | None = None) -> tuple:
    """Complex channel-rate (C, M) -> (bits, sync scores, count): best-
    phase timing, the differential demod, TS1/TS2 scores.

    z_rot: per-carrier (cos, sin) of the deferred residual rotation,
    applied to z; the sector quantizer then decides, and z = 0 (the
    zero padding past `count`) goes to bin 0, as atan2(0, 0) = 0 puts it
    without z_rot."""
    ts = best_phase_pick(y, sps)
    if z_rot is None:
        hard = dqpsk.demodulate_hard(ts.symbols, profile="ref")
    else:
        s = ts.symbols
        z = s[..., 1:] * s[..., :-1].conj()
        z = z * torch.complex(z_rot[0], -z_rot[1])[..., None]
        zr, zi = z.real, z.imag
        hard = dqpsk.quantize_z_ref(zr, zi)
        hard = torch.where((zr == 0) & (zi == 0), 0, hard).to(torch.uint8)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return bits, corr, ts.count


# the composite convs: (frontend, x, gc, L, decim) -> un-derotated (yr, yi)

def _conv_dense(fe, x, gc, L, decim):
    return fused.fused_channelize_ri(x, fe.kernel, gc, None, decim,
                                     rotate=False)


def _conv_s2d(fe, x, *geometry):
    return fused.fused_channelize_s2d_ri(x, fe.kernel_s2d, *geometry)


def _conv_s2d_of(fe, x, *geometry):
    return fused.fused_channelize_s2d_of_ri(x, fe.kernel_of, *geometry,
                                            fe.fold)


def _conv_k1(fe, x, *geometry):
    return fused.pair_rows(s2d_conv(x, fe.kernel_s2d, *geometry,
                                    bf16=fe.bf16, tc=fe.packed()))


def _conv_k1_of(fe, x, *geometry):
    return fused.pair_rows(s2d_conv_of(x, fe.kernel_of, *geometry, fe.fold,
                                       bf16=fe.bf16, tc=fe.packed()))


def _conv_k3(fe, x, *geometry):
    return fused.pair_rows(s2d_conv_db(x, fe.kernel_s2d, *geometry))


@dataclass(frozen=True)
class ConvVariant:
    """Everything a conv name decides: one entry of CONV_VARIANTS."""
    runs: str              # what runs the channelizer (--conv's help)
    frontends: tuple       # (DDC-bank class, full-band class), or None
    cli: bool = False      # a --conv choice of the reference's CLI
    channelize: Callable | None = None   # None: a frontend of its own
    weights: str = "kernel_s2d"          # the buffer the conv reads
    fold: int | None = 0   # None: the most, up to 8, in 128 rows
    bf16: bool = False     # bf16 operands (the tensor cores on a card)
    complex_demod: bool = False   # on the DDC bank, the complex front
    kernel: str | None = None     # its kernel's launch counter


@dataclass(frozen=True)
class FrontendState:
    """What the frontend convolves and rotates with: the (C2, 2D, Lp) s2d
    kernel, its composite length L and group delay gc, the decimation D,
    the per-carrier (cos, sin) of the deferred z rotation, and the
    (2C, 2, L) kernel it came from (the "fused" conv's).  The folded convs
    fold the s2d kernel (ops.fused.fold_s2d_kernel), so every conv of
    both packages convolves with the identical kernel."""
    kernel_s2d: np.ndarray
    gc: int
    L: int
    decim: int
    z_cos: np.ndarray
    z_sin: np.ndarray
    kernel: np.ndarray | None = None


def state_from_reference(kernel, gc: int, rot_cycles, decim: int,
                         sps: int) -> FrontendState:
    """FrontendState from the (kernel, gc, rot_cycles) triple that
    `tetraear_tpu.ops.fused.fused_kernel` (or this package's copy)
    returns, so that both packages convolve with the identical kernel."""
    kernel = np.array(kernel, np.float32)              # a writable copy
    z_cos, z_sin = fused.symbol_rotation(np.asarray(rot_cycles), decim, sps)
    return FrontendState(fused.s2d_kernel(kernel, decim), int(gc),
                         kernel.shape[-1], decim, z_cos, z_sin, kernel)


class MulticarrierFrontend(CandidateStage):
    """Device pipeline for one carrier-offset set: composite conv ->
    demod -> candidates, as the entry of `conv` (CONV_VARIANTS) says.
    Buffers: the s2d kernel, the weights the conv reads beside it (the
    folded kernel, or the (2C, 2, L) kernel for "fused"), the packed
    tensor-core weights of a bf16 conv on a card, the z rotation (cos,
    sin) and the CRC matrix."""

    full_band = False

    def __init__(self, state: FrontendState, *, sps: int, device,
                 num_candidates: int = 64, threshold: float = 0.80,
                 conv: str = "pallas_bf16"):
        super().__init__(sps=sps, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.variant = conv_variant(conv, pfb=self.full_band,
                                    decim=state.decim)
        if self.variant.channelize is None:
            raise _refusal(f"conv {conv!r} is a frontend of its own: "
                           "build_frontend makes it", self.full_band)
        self.conv, self.bf16 = conv, self.variant.bf16
        fold, c2 = self.variant.fold, state.kernel_s2d.shape[0]
        self.fold = max(1, min(8, 128 // c2)) if fold is None else fold
        self.gc, self.L, self.decim = state.gc, state.L, state.decim
        device = torch.device(device)
        self.register_buffer("kernel_s2d", torch.as_tensor(
            state.kernel_s2d, dtype=torch.float32, device=device))
        if self.variant.weights == "kernel_of":
            self.register_buffer("kernel_of", torch.as_tensor(
                fused.fold_s2d_kernel(state.kernel_s2d, self.fold),
                device=device))
        elif self.variant.weights == "kernel":
            self.register_buffer("kernel", torch.as_tensor(
                state.kernel, dtype=torch.float32, device=device))
        # the tensor-core route's packed weights, made once (on a card)
        self.tc = None
        if self.bf16 and device.type == "cuda":
            self.tc = (tc_pack(self.kernel_of, self.fold) if self.fold
                       else tc_pack_k1(self.kernel_s2d))
            self.register_buffer("kernel_tc", self.tc.packed)
        self.register_buffer("z_cos", torch.as_tensor(state.z_cos,
                                                      device=device))
        self.register_buffer("z_sin", torch.as_tensor(state.z_sin,
                                                      device=device))

    @classmethod
    def from_offsets(cls, offsets_hz, config: ReceiverConfig | None = None,
                     **kwargs) -> "MulticarrierFrontend":
        """Build the composite kernel for `offsets_hz` with this package's
        designers (the reference's `_fused_stages` recipe)."""
        cfg = config or ReceiverConfig()
        decim = cfg.decimation_factor
        cutoff = ((cfg.channel_bandwidth_hz / 2)
                  / (cfg.intermediate_rate_hz / 2))
        kernel, gc, rot = fused.fused_kernel(
            np.asarray(offsets_hz, np.float64), cfg.sample_rate_hz, decim,
            cfg.decim_fir_taps_per_phase, cfg.channel_fir_taps, cutoff)
        return cls.from_reference(kernel, gc, rot, cfg, **kwargs)

    @classmethod
    def from_reference(cls, kernel, gc: int, rot_cycles,
                       config: ReceiverConfig | None = None,
                       **kwargs) -> "MulticarrierFrontend":
        """Build from a (kernel, gc, rot_cycles) triple of fused_kernel."""
        cfg = config or ReceiverConfig()
        sps = cfg.ref_samples_per_symbol
        state = state_from_reference(kernel, gc, rot_cycles,
                                     cfg.decimation_factor, sps)
        return cls(state, sps=sps, **kwargs)

    def channelize(self, x: torch.Tensor, start_index: int = 0) -> tuple:
        """(N,) complex64 on the module's device -> un-derotated (yr, yi).
        The rotation is deferred to z as a per-carrier constant, so
        `start_index` is not read."""
        return self.variant.channelize(self, x, self.gc, self.L, self.decim)

    def packed(self):
        """The tensor-core route's packed weights (None off the route)."""
        return self.tc and self.tc._replace(packed=self.kernel_tc)

    def demod(self, y: tuple) -> tuple:
        """(bits, sync scores, count) of the un-derotated (yr, yi): the
        real-pair tail, or for "fused" on the DDC bank the complex demod
        front; the full band takes the real-pair tail for every conv."""
        z_rot = (self.z_cos, self.z_sin)
        if self.variant.complex_demod and not self.full_band:
            return _demod_front(torch.complex(*y), self.sps, z_rot)
        res = _demod_from_pair(*y, self.sps, z_rot=z_rot)
        return res.bits, res.sync_corr, res.count


class PfbMulticarrierFrontend(MulticarrierFrontend):
    """Full-band filterbank frontend (port of the reference's
    `PfbMulticarrierFrontend` for its fused=True, s2d, pallas,
    pallas_bf16 and pallas_db variants): the polyphase DFT filterbank of
    all fs / 25 kHz channels (96 at 2.4 MS/s) as one dense conv of 2 x 96
    rows, then the real-pair demod tail and candidates over every
    channel.  Row c is the channel at `channel_offsets_hz()[c]` (fftfreq
    order).  The gather form (fused=False) is `GatherPfbFrontend`."""

    full_band = True

    def __init__(self, state: FrontendState, *, sample_rate_hz: float,
                 conv: str = "pallas_bf16", **kwargs):
        super().__init__(state, conv=conv, **kwargs)
        self.sample_rate_hz = sample_rate_hz
        self.num_channels = state.kernel_s2d.shape[0] // 2

    @classmethod
    def from_config(cls, config: ReceiverConfig | None = None,
                    taps_per_branch: int = 8,
                    **kwargs) -> "PfbMulticarrierFrontend":
        """Build the filterbank kernel with this package's designers (the
        reference's constructor recipe)."""
        cfg = config or ReceiverConfig()
        num_channels = int(round(cfg.sample_rate_hz / 25e3))
        kernel, gc, rot = fused.pfb_kernel(num_channels, cfg.sample_rate_hz,
                                           taps_per_branch=taps_per_branch)
        return cls.from_reference(kernel, gc, rot, cfg, **kwargs)

    @classmethod
    def from_reference(cls, kernel, gc: int, rot_cycles,
                       config: ReceiverConfig | None = None,
                       **kwargs) -> "PfbMulticarrierFrontend":
        """Build from a (kernel, gc, rot_cycles) triple of pfb_kernel."""
        cfg = config or ReceiverConfig()
        return super().from_reference(kernel, gc, rot_cycles, cfg,
                                       sample_rate_hz=cfg.sample_rate_hz,
                                       **kwargs)

    def channel_offsets_hz(self) -> np.ndarray:
        """Center frequency of each channel row (fftfreq order)."""
        return pfb.channel_offsets_hz(self.num_channels, self.sample_rate_hz)


class StagedMulticarrierFrontend(CandidateStage):
    """The staged DDC bank, the reference's `MulticarrierFrontend(fused=
    False)`: `channelize` (K5 on a CUDA device, the plain mixer + strided
    FIR on the CPU), the channel FIR (`fir_filter_same`), the complex
    demod front, the candidates.  The mixer's phase runs on the global
    sample index, so the result depends on `start_index`."""

    def __init__(self, state: StagedState, *, sps: int, device,
                 num_candidates: int = 64, threshold: float = 0.80):
        super().__init__(sps=sps, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.sample_rate_hz = state.sample_rate_hz
        self.decim = state.decim
        device = torch.device(device)
        for name in ("offsets_hz", "taps_d", "taps_c"):
            self.register_buffer(name, torch.as_tensor(
                getattr(state, name), dtype=torch.float32, device=device))

    @classmethod
    def from_offsets(cls, offsets_hz, config: ReceiverConfig | None = None,
                     **kwargs) -> "StagedMulticarrierFrontend":
        """Build with this package's FIR designers."""
        cfg = config or ReceiverConfig()
        return cls(staged_state(offsets_hz, cfg),
                   sps=cfg.ref_samples_per_symbol, **kwargs)

    def channelize(self, x: torch.Tensor, start_index: int = 0
                   ) -> torch.Tensor:
        """(N,) complex64 -> (C, ceil(N/D)) complex64 channels."""
        y = channelize(x, self.offsets_hz, self.sample_rate_hz, self.decim,
                       self.taps_d, start_index)
        return fir_filter_same(y, self.taps_c)

    def demod(self, y: torch.Tensor) -> tuple:
        return _demod_front(y, self.sps)


class GatherPfbFrontend(CandidateStage):
    """The gather-form full band, the reference's
    `PfbMulticarrierFrontend(fused=False)`: `pfb.pfb_channelize` over all
    fs / 25 kHz channels (96 at 2.4 MS/s), the complex demod front, the
    candidates.  Row c is the channel at `channel_offsets_hz()[c]`."""

    def __init__(self, config: ReceiverConfig | None = None, *, device,
                 num_candidates: int = 64, threshold: float = 0.80,
                 taps_per_branch: int = 8):
        cfg = config or ReceiverConfig()
        super().__init__(sps=cfg.ref_samples_per_symbol, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.sample_rate_hz = cfg.sample_rate_hz
        self.num_channels = int(round(cfg.sample_rate_hz / 25e3))
        self.decim = cfg.decimation_factor
        self.register_buffer("taps", torch.as_tensor(
            pfb.design_prototype(self.num_channels, taps_per_branch),
            dtype=torch.float32, device=torch.device(device)))

    def channel_offsets_hz(self) -> np.ndarray:
        return pfb.channel_offsets_hz(self.num_channels, self.sample_rate_hz)

    def channelize(self, x: torch.Tensor, start_index: int = 0
                   ) -> torch.Tensor:
        """(N,) complex64 -> (96, ceil(N/D)) complex64 channels;
        `start_index` is not read, as in the reference."""
        return pfb.pfb_channelize(x, self.num_channels, self.decim,
                                  self.taps)

    def demod(self, y: torch.Tensor) -> tuple:
        return _demod_front(y, self.sps)


_MC, _PFB = MulticarrierFrontend, PfbMulticarrierFrontend

# conv name -> ConvVariant; the names keep the reference's, and its
# `fused=` argument maps to them: False -> "staged" (DDC bank) or
# "gather" (PFB), True -> "fused", a string -> the same name.  <N> is a
# fold (2D * N <= 128).  A new conv is one entry and its kernel wrapper.
CONV_VARIANTS = {
    "staged": ConvVariant(
        "the staged chain (fused=False): channelize, K5 "
        "(csrc/fused_channelize.cu) on CUDA and the mixer + strided "
        "F.conv1d on the CPU, then the channel FIR",
        (StagedMulticarrierFrontend, None), kernel="fused_channelize"),
    "gather": ConvVariant(
        "the gather-form polyphase filterbank (fused=False): window "
        "gathers, fold, IFFT", (None, GatherPfbFrontend)),
    "fused": ConvVariant(
        "the legacy dense conv (fused=True): stride-D F.conv1d of the "
        "(2C, 2, L) kernel, f32", (_MC, _PFB), channelize=_conv_dense,
        weights="kernel", complex_demod=True),
    "s2d": ConvVariant("plain F.conv1d, f32", (_MC, _PFB), cli=True,
                       channelize=_conv_s2d),
    "s2d_of": ConvVariant(
        "plain F.conv1d with fold = max(1, min(8, 128 // C2)) output "
        "positions folded into rows, f32", (_MC, None), cli=True,
        channelize=_conv_s2d_of, weights="kernel_of", fold=None),
    "pallas": ConvVariant("K1 (csrc/s2d_conv.cu), f32 operands",
                          (_MC, _PFB), cli=True, channelize=_conv_k1,
                          kernel="s2d_conv"),
    "pallas_bf16": ConvVariant(
        "K1 (csrc/s2d_conv_tc.cu), bf16 operands on the tensor cores, f32 "
        "accumulation", (_MC, _PFB), cli=True, channelize=_conv_k1,
        bf16=True, kernel="s2d_conv_bf16"),
    "pallas_db": ConvVariant(
        "K3 (csrc/s2d_conv_db.cu): K1 with the next tile's input "
        "prefetched by cp.async, f32", (_MC, _PFB), channelize=_conv_k3,
        kernel="s2d_conv_db"),
    "pallas_of<N>": ConvVariant(
        "K1-of (csrc/s2d_conv.cu, fold N), f32 operands", (_MC, None),
        channelize=_conv_k1_of, weights="kernel_of", kernel="s2d_conv_of"),
    "pallas_of<N>_bf16": ConvVariant(
        "K1-of (csrc/s2d_conv_tc.cu, fold N), bf16 operands on the tensor "
        "cores, f32 accumulation", (_MC, None), channelize=_conv_k1_of,
        weights="kernel_of", bf16=True, kernel="s2d_conv_of_bf16"),
}


def _refusal(message: str, pfb: bool) -> ValueError:
    """`message`, then the convs of the frontend asked for."""
    return ValueError(f"{message}; {'PFB' if pfb else '16-carrier'} convs: "
                      + ", ".join(k for k, v in CONV_VARIANTS.items()
                                  if v.frontends[pfb]))


def conv_variant(conv: str, *, pfb: bool = False,
                 decim: int | None = None) -> ConvVariant:
    """The entry of conv name `conv` on the full band (pfb=True) or the
    DDC bank: the one parse and check of a conv name.  pallas_of<N> and
    pallas_of<N>_bf16 come with their fold N, which K1-of must take at
    decimation `decim` (the default configuration's if None).  An unknown
    name, a conv of the other frontend or such a fold raises."""
    name = "pallas_of<N>" if conv.startswith("pallas_of") else conv
    if name not in CONV_VARIANTS:
        raise _refusal(f"unknown conv variant {conv!r}; valid: "
                       + ", ".join(CONV_VARIANTS), pfb)
    if CONV_VARIANTS[name].frontends[pfb] is None:
        raise _refusal(f"conv {conv!r} is not a variant of the "
                       f"{'full-band' if pfb else '16-carrier'} frontend", pfb)
    if name != "pallas_of<N>":
        return CONV_VARIANTS[name]
    fold, bf16 = parse_fold(conv, "pallas_of")
    check_fold(fold, decim or ReceiverConfig().decimation_factor)
    return replace(CONV_VARIANTS[name + "_bf16" if bf16 else name], fold=fold)


def build_frontend(conv: str, *, device, pfb: bool = False,
                   offsets_hz=None, config: ReceiverConfig | None = None,
                   **kwargs) -> CandidateStage:
    """The frontend that runs `conv` (a CONV_VARIANTS name) on `device`:
    the full band with pfb=True, else the DDC bank on `offsets_hz`."""
    cfg = config or ReceiverConfig()
    cls = conv_variant(conv, pfb=pfb,
                       decim=cfg.decimation_factor).frontends[pfb]
    if cls is GatherPfbFrontend:
        return cls(cfg, device=device, **kwargs)
    if cls is StagedMulticarrierFrontend:
        return cls.from_offsets(offsets_hz, cfg, device=device, **kwargs)
    if pfb:
        return cls.from_config(cfg, device=device, conv=conv, **kwargs)
    return cls.from_offsets(offsets_hz, cfg, device=device, conv=conv,
                            **kwargs)


def slot_positions(counts, found, accepted) -> list:
    """Each row's sync positions, int64, whose 510-bit slot starts inside
    the row (`TetraDecoder.walk`'s filter: start = pos - 216 >= 0 and
    start // 2 + 255 <= the row's symbols), from its symbol count (C,)
    and the walk's positions (C, cap) and accepted counts (C,)
    (`ops.sync.sync_walk`)."""
    nsym = np.maximum(counts.astype(np.int64) - 1, 0)
    pos = found.astype(np.int64)
    start = pos - C.SYNC_TO_FRAME_START_BITS
    keep = ((np.arange(pos.shape[1]) < accepted[:, None]) & (start >= 0)
            & (start // 2 + C.SYMBOLS_PER_SLOT <= nsym[:, None]))
    return [row[k] for row, k in zip(pos, keep)]


class MulticarrierDecoder:
    """Host decode over MulticarrierResult: one stateful TetraDecoder per
    carrier, fed from the device bit streams and dense sync scores; the
    decoders take `device` (the frontend's) for their own sync scores."""

    def __init__(self, num_carriers: int, auto_decrypt: bool = False, *,
                 device):
        self.decoders = [TetraDecoder(auto_decrypt=auto_decrypt,
                                      device=device)
                         for _ in range(num_carriers)]

    def walks(self, bits, counts, positions) -> list:
        """Each row's SlotWalk from the pulled frontend result: its bits
        (C, B) uint8 and symbol counts (C,), and its sync positions as
        `slot_positions` keeps them."""
        walks = []
        for c, dec in enumerate(self.decoders):
            cbits = bits[c, :2 * max(int(counts[c]) - 1, 0)]
            mapped = (cbits[0::2].astype(np.int64) << 1) | cbits[1::2]
            walks.append(SlotWalk(dec, cbits, mapped, positions[c]))
        return walks

    def decode(self, result: MulticarrierResult) -> list:
        """-> list of per-carrier frame lists; frames gain a 'carrier' key.
        Every row's sync walk at once, where the scores lie
        (`ops.sync.sync_walk`: on a card one kernel launch, queued before
        the pulls), each row's hits whose slot starts inside it, then one
        frame decode over all their slots (`decode_walks`: one batch, then
        each row's frames by its own decoder, in row order).  A chunk span
        `tetra.decode` (utils.metrics) holds the device-to-host pulls of
        the bits, the counts and the walk's positions, which wait on the
        stream (`tetra.decode.pull`), and the rows (`tetra.decode.rows`),
        where the inner span `sync` is the host part of the walk,
        `slot_positions`, once a chunk (counters `sync.rows`, the rows
        walked, and `sync.kernel`, those the kernel walked)."""
        with span("tetra.decode"):
            found, accepted = sync.sync_walk(result.sync_corr, result.count)
            with span("tetra.decode.pull"):
                bits = result.bits.cpu().numpy()
                counts = result.count.cpu().numpy()
                found = found.cpu().numpy()
                accepted = accepted.cpu().numpy()
            with span("tetra.decode.rows"):
                traced = tracing()
                t0 = time.perf_counter_ns() if traced else 0
                positions = slot_positions(counts, found, accepted)
                if traced:
                    rows = len(positions)
                    record("sync", time.perf_counter_ns() - t0, 1,
                           {"sync.rows": rows, "sync.kernel":
                            rows if result.sync_corr.is_cuda else 0})
                out = decode_walks(self.walks(bits, counts, positions))
                for c, frames in enumerate(out):
                    for f in frames:
                        f["carrier"] = c
        return out
