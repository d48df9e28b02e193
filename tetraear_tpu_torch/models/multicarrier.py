"""Multicarrier full decode (BASELINE config 4) and the full-band PFB
decode, port of `tetraear_tpu.models.multicarrier`: one wideband IQ
block -> per-carrier bits, dense sync scores and fixed-K frame candidates
with soft-CRC verdicts, with only MAC/SDS parsing left to the host.

Stages of `MulticarrierFrontend.forward`:
  1. the composite s2d conv (mixer + decimating FIR + channel FIR), by
     the conv named in CONV_VARIANTS: a plain F.conv1d version or a
     hand-written kernel (K1, K1-of, K3), or the legacy strided dense
     conv ("fused");
  2. the real-pair demod tail (models.realpair._demod_from_pair), or for
     the 16-carrier "fused" conv the complex demod front (_demod_front);
  3. the candidates stage (models.candidates.extract_candidates): top-K
     sync positions, 510-bit frame windows, batched soft CRC.
`PfbMulticarrierFrontend` runs the same stages over all 96 channels of
the 25 kHz grid at 2.4 MS/s, its conv the polyphase filterbank as one
dense conv (`ops.fused.pfb_kernel`, 192 rows).
The staged chains, the reference's `fused=False`, are frontends of their
own: `StagedMulticarrierFrontend` (channelize — K5 on the card — then
the channel FIR and `_demod_front`) and `GatherPfbFrontend` (the
gather-form filterbank, then `_demod_front`).  `build_frontend` maps a
conv name to its frontend; `MulticarrierDecoder` is the host decode over
any of their results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.core.decoder import TetraDecoder
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


class ConvVariant(NamedTuple):
    runs: str    # what runs the channelizer
    cli: bool    # a --conv choice of the reference's CLI
    pfb: bool    # a variant of the full-band (PFB) frontend
    ddc: bool    # a variant of the 16-carrier (DDC-bank) frontend


# conv name -> ConvVariant; the names keep the reference's, and its
# `fused=` argument maps to them: False -> "staged" (DDC bank) or
# "gather" (PFB), True -> "fused", a string -> the same name.  <N> is a
# fold (2D * N <= 128).  build_frontend and the CLI read this table.
CONV_VARIANTS = {
    "staged": ConvVariant("the staged chain (fused=False): channelize, "
                          "K5 (csrc/fused_channelize.cu) on CUDA and the "
                          "mixer + strided F.conv1d on the CPU, then the "
                          "channel FIR", cli=False, pfb=False, ddc=True),
    "gather": ConvVariant("the gather-form polyphase filterbank "
                          "(fused=False): window gathers, fold, IFFT",
                          cli=False, pfb=True, ddc=False),
    "fused": ConvVariant("the legacy dense conv (fused=True): stride-D "
                         "F.conv1d of the (2C, 2, L) kernel, f32",
                         cli=False, pfb=True, ddc=True),
    "s2d": ConvVariant("plain F.conv1d, f32", cli=True, pfb=True, ddc=True),
    "s2d_of": ConvVariant("plain F.conv1d with fold = max(1, min(8, "
                          "128 // C2)) output positions folded into rows, "
                          "f32", cli=True, pfb=False, ddc=True),
    "pallas": ConvVariant("K1 (csrc/s2d_conv.cu), f32 operands",
                          cli=True, pfb=True, ddc=True),
    "pallas_bf16": ConvVariant("K1 (csrc/s2d_conv_tc.cu), bf16 operands on "
                               "the tensor cores, f32 accumulation",
                               cli=True, pfb=True, ddc=True),
    "pallas_db": ConvVariant("K3 (csrc/s2d_conv_db.cu): K1 with the next "
                             "tile's input prefetched by cp.async, f32",
                             cli=False, pfb=True, ddc=True),
    "pallas_of<N>": ConvVariant("K1-of (csrc/s2d_conv.cu, fold N), f32 "
                                "operands", cli=False, pfb=False, ddc=True),
    "pallas_of<N>_bf16": ConvVariant("K1-of (csrc/s2d_conv_tc.cu, fold N), "
                                     "bf16 operands on the tensor cores, "
                                     "f32 accumulation",
                                     cli=False, pfb=False, ddc=True),
}
PFB_CONV_VARIANTS = tuple(k for k, v in CONV_VARIANTS.items() if v.pfb)
_STAGED = ("staged", "gather")   # frontends of their own


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


def _demod_tail(y: torch.Tensor, sps: int, k: int, threshold: float,
                crc: tuple) -> MulticarrierResult:
    """_demod_front then the candidates stage; crc = (crc_a, crc_c0)."""
    return candidate_stage(*_demod_front(y, sps), k, threshold, *crc)


def conv_fold(conv: str, c2: int, decim: int) -> tuple:
    """conv name -> (fold, bf16): fold 0 for the un-folded convs.  An
    unknown name, a staged chain or a fold K1-of does not take raises."""
    if conv.startswith("pallas_of"):
        fold, bf16 = parse_fold(conv, "pallas_of")
        check_fold(fold, decim)
        return fold, bf16
    if conv == "s2d_of":
        return max(1, min(8, 128 // c2)), False
    if conv in _STAGED:
        raise ValueError(f"conv {conv!r} is a frontend of its own: "
                         "build_frontend makes it")
    if conv not in CONV_VARIANTS or "<" in conv:
        raise ValueError(f"unknown conv variant {conv!r}; valid: "
                         + ", ".join(CONV_VARIANTS))
    return 0, conv == "pallas_bf16"


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
    demod tail -> candidates.  Buffers: the s2d kernel (its folded form
    for the folded convs, the (2C, 2, L) kernel for "fused"), the z
    rotation (cos, sin) and the CRC matrix.  `conv` names a CONV_VARIANTS
    entry."""

    def __init__(self, state: FrontendState, *, sps: int, device,
                 num_candidates: int = 64, threshold: float = 0.80,
                 conv: str = "pallas_bf16"):
        super().__init__(sps=sps, device=device,
                         num_candidates=num_candidates, threshold=threshold)
        self.fold, self.bf16 = conv_fold(conv, state.kernel_s2d.shape[0],
                                         state.decim)
        self.conv = conv
        self.gc, self.L, self.decim = state.gc, state.L, state.decim
        device = torch.device(device)
        self.register_buffer("kernel_s2d", torch.as_tensor(
            state.kernel_s2d, dtype=torch.float32, device=device))
        if self.fold:
            self.register_buffer("kernel_of", torch.as_tensor(
                fused.fold_s2d_kernel(state.kernel_s2d, self.fold),
                device=device))
        if conv == "fused":
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

    def channelize(self, x: torch.Tensor) -> tuple:
        """(N,) complex64 on the module's device -> un-derotated (yr, yi)."""
        if self.conv == "fused":
            return fused.fused_channelize_ri(x, self.kernel, self.gc, None,
                                             self.decim, rotate=False)
        args = (self.gc, self.L, self.decim)
        if self.conv == "s2d":
            return fused.fused_channelize_s2d_ri(x, self.kernel_s2d, *args)
        if self.conv == "s2d_of":
            return fused.fused_channelize_s2d_of_ri(x, self.kernel_of, *args,
                                                    self.fold)
        if self.conv == "pallas_db":
            out = s2d_conv_db(x, self.kernel_s2d, *args)
        else:
            tc = self.tc and self.tc._replace(packed=self.kernel_tc)
            if self.fold:
                out = s2d_conv_of(x, self.kernel_of, *args, self.fold,
                                  bf16=self.bf16, tc=tc)
            else:
                out = s2d_conv(x, self.kernel_s2d, *args, bf16=self.bf16,
                               tc=tc)
        c = out.shape[0] // 2
        return out[:c], out[c:]

    def demod(self, yr: torch.Tensor, yi: torch.Tensor) -> tuple:
        """(bits, sync scores, count) of the un-derotated pair: the real-
        pair tail, or for the 16-carrier "fused" conv the reference's
        complex demod front."""
        z_rot = (self.z_cos, self.z_sin)
        if self.conv == "fused":
            return _demod_front(torch.complex(yr, yi), self.sps, z_rot)
        res = _demod_from_pair(yr, yi, self.sps, z_rot=z_rot)
        return res.bits, res.sync_corr, res.count

    def forward(self, x, start_index: int = 0) -> MulticarrierResult:
        """x: (N,) complex IQ (numpy or tensor), moved to the module's
        device.  `start_index` (the block's first sample index) is taken
        for parity with the reference's call: the rotation is deferred to
        z as a per-carrier constant, so the result does not depend on it."""
        x = torch.as_tensor(x, device=self.device).to(torch.complex64)
        yr, yi = self.channelize(x.contiguous())
        return self.candidates(*self.demod(yr, yi))


class PfbMulticarrierFrontend(MulticarrierFrontend):
    """Full-band filterbank frontend (port of the reference's
    `PfbMulticarrierFrontend` for its fused=True, s2d, pallas,
    pallas_bf16 and pallas_db variants): the polyphase DFT filterbank of
    all fs / 25 kHz channels (96 at 2.4 MS/s) as one dense conv of 2 x 96
    rows, then the real-pair demod tail and candidates over every
    channel.  Row c is the channel at `channel_offsets_hz()[c]` (fftfreq
    order).  The gather form (fused=False) is `GatherPfbFrontend`."""

    def __init__(self, state: FrontendState, *, sample_rate_hz: float,
                 conv: str = "pallas_bf16", **kwargs):
        if conv not in PFB_CONV_VARIANTS or conv in _STAGED:
            raise ValueError(f"unknown PFB conv variant {conv!r}; valid: "
                             + ", ".join(v for v in PFB_CONV_VARIANTS
                                         if v not in _STAGED))
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

    def demod(self, yr: torch.Tensor, yi: torch.Tensor) -> tuple:
        res = _demod_from_pair(yr, yi, self.sps,
                               z_rot=(self.z_cos, self.z_sin))
        return res.bits, res.sync_corr, res.count

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

    def forward(self, x, start_index: int = 0) -> MulticarrierResult:
        x = torch.as_tensor(x, device=self.device).to(torch.complex64)
        y = self.channelize(x.contiguous(), start_index)
        return _demod_tail(y, self.sps, self.num_candidates, self.threshold,
                           (self.crc_a, self.crc_c0))


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

    def forward(self, x, start_index: int = 0) -> MulticarrierResult:
        """x: (N,) complex IQ; `start_index` is taken for the CLI's call
        and not used, as in the reference."""
        x = torch.as_tensor(x, device=self.device).to(torch.complex64)
        y = pfb.pfb_channelize(x, self.num_channels, self.decim, self.taps)
        return _demod_tail(y, self.sps, self.num_candidates, self.threshold,
                           (self.crc_a, self.crc_c0))


def build_frontend(conv: str, *, device, pfb: bool = False,
                   offsets_hz=None, config: ReceiverConfig | None = None,
                   **kwargs) -> CandidateStage:
    """The frontend that runs `conv` (a CONV_VARIANTS name) on `device`:
    the full band with pfb=True, else the DDC bank on `offsets_hz`."""
    if conv.startswith("pallas_of"):
        variant = CONV_VARIANTS["pallas_of<N>"]
    elif conv in CONV_VARIANTS:
        variant = CONV_VARIANTS[conv]
    else:
        raise ValueError(f"unknown conv variant {conv!r}; valid: "
                         + ", ".join(CONV_VARIANTS))
    if not (variant.pfb if pfb else variant.ddc):
        raise ValueError(f"conv {conv!r} is not a variant of the "
                         f"{'full-band' if pfb else '16-carrier'} frontend")
    if conv == "gather":
        return GatherPfbFrontend(config, device=device, **kwargs)
    if pfb:
        return PfbMulticarrierFrontend.from_config(config, device=device,
                                                   conv=conv, **kwargs)
    if conv == "staged":
        return StagedMulticarrierFrontend.from_offsets(
            offsets_hz, config, device=device, **kwargs)
    return MulticarrierFrontend.from_offsets(offsets_hz, config,
                                             device=device, conv=conv,
                                             **kwargs)


class MulticarrierDecoder:
    """Host decode over MulticarrierResult: one stateful TetraDecoder per
    carrier, fed from the device bit streams and dense sync scores; the
    decoders take `device` (the frontend's) for their own sync scores."""

    def __init__(self, num_carriers: int, auto_decrypt: bool = False, *,
                 device):
        self.decoders = [TetraDecoder(auto_decrypt=auto_decrypt,
                                      device=device)
                         for _ in range(num_carriers)]

    def decode(self, result: MulticarrierResult) -> list:
        """-> list of per-carrier frame lists; frames gain a 'carrier' key."""
        bits = result.bits.cpu().numpy()
        corr = result.sync_corr.cpu().numpy()
        counts = result.count.cpu().numpy()
        out = []
        for c, dec in enumerate(self.decoders):
            nsym = max(int(counts[c]) - 1, 0)
            nbits = 2 * nsym
            cbits = bits[c, :nbits]
            mapped = (cbits[0::2].astype(np.int64) << 1) | cbits[1::2]
            ncorr = max(0, nbits - 21)
            frames = dec.decode_frontend(cbits, mapped, corr[c, :ncorr])
            for f in frames:
                f["carrier"] = c
            out.append(frames)
        return out
