"""Pod-scale sharded receive step (BASELINE config 5), one rank per shard
of a (carrier, time) mesh (parallel/mesh.py).

* the wideband IQ is cut along `time` (every carrier group takes the
  same time block), the carrier offsets along `carrier`
  (`shard_inputs`);
* each rank extends its block with overlap-save halos from its time
  neighbours (parallel/halo.py), so filtering, timing and demod on the
  block's interior are those of the unsharded program;
* the per-carrier symbol-timing power is summed over the time axis
  (`psum`), so every time shard picks the same, global sampling phase:
  the reference's whole-block argmax done as a collective;
* the halo overlap gives every owned symbol its predecessor inside the
  extended block, so the differential demod starts at the block's first
  symbol and no symbol is carried across shard edges;
* each builder returns a callable of this rank's local inputs, whose
  result is this rank's extended segment (C_local, 1, ...);
  `gather_result` assembles the global (C, n_time, ...) result on every
  rank, which `ShardedReceiver.decode` and
  `ShardedDownlinkReceiver.stitch` cut back to each shard's owned
  region.

Shard contracts: the local block length T and the halo H are multiples
of decim x sps (130 at the reference rates) for the staged and fused
steps, of decim x 10 x etsi_sps (400) for the etsi step and of
lcm(130, 96) = 6240 for the real-pair step, so the decimation, resampler,
symbol and mixer-table grids stay globally aligned across shards.

The staged and etsi steps channelize through `channelizer.channelize`:
K5 (csrc/fused_channelize.cu) on a CUDA device, at the extended block's
global start index, which is negative (-H) on the first time shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.ops import (channelizer, dqpsk, fir, fused, resample,
                                    sync)
from tetraear_tpu_torch.ops.fir import _conv1d_real
from tetraear_tpu_torch.parallel.halo import (extend_with_halo, gather_global,
                                              psum)
from tetraear_tpu_torch.parallel.mesh import CARRIER_AXIS, TIME_AXIS, Mesh


class ShardedResult(NamedTuple):
    bits: torch.Tensor        # (C, n_time, B_ext) uint8: extended segments
    sync_corr: torch.Tensor   # (C, n_time, B_ext-21) float32
    best_phase: torch.Tensor  # (C, n_time) int32 (same on every shard)


class ShardedEtsiResult(NamedTuple):
    soft_bits: torch.Tensor   # (C, n_time, 2*(M_ext-1)) float32 LLRs
    best_phase: torch.Tensor  # (C, n_time) int32 (same on every shard)


def _check_mesh(mesh: Mesh, device) -> torch.device:
    """The builders' device rule: an explicit device of the mesh's type,
    on a rank inside the mesh."""
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} on a {mesh.device_type} mesh")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh.index(TIME_AXIS)                 # raises outside the mesh
    return device


def _check_block(x: torch.Tensor, device: torch.device, align: int) -> None:
    if x.device != device:
        raise ValueError(f"block on {x.device}; the step runs on {device}")
    if x.shape[-1] % align:
        raise ValueError(f"a block of {x.shape[-1]} samples; the step takes "
                         f"multiples of {align}")


def _global_start(mesh: Mesh, t_local: int, halo: int) -> int:
    """The extended block's first global sample index (-halo on the
    first time shard)."""
    return mesh.index(TIME_AXIS) * t_local - halo


def _phase_best(grid_power: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(C_l, M, sps) interior power -> (C_l,) best phase of the power
    summed over the time axis (the first maximum wins)."""
    phase_power = psum(grid_power.sum(dim=1), mesh, TIME_AXIS)
    return torch.argmax(phase_power, dim=-1)


def _on_grid(y: torch.Tensor, best: torch.Tensor, sps: int) -> torch.Tensor:
    """Samples of y (C_l, N) at best + m sps, m < N // sps - 1."""
    m_ext = y.shape[-1] // sps - 1
    idx = best[:, None] + torch.arange(m_ext, device=y.device)[None] * sps
    return torch.gather(y, 1, idx)


def _shard_step(x_local: torch.Tensor, offsets_local: torch.Tensor,
                taps_d: torch.Tensor, taps_c: torch.Tensor,
                cfg: ReceiverConfig, halo: int, mesh: Mesh) -> ShardedResult:
    """One rank: (T,) local wideband + (C_local,) offsets, staged chain."""
    decim = cfg.decimation_factor
    t_local = x_local.shape[-1]
    ext = extend_with_halo(x_local, halo, halo, mesh)          # (T+2H,)
    y = channelizer.channelize(ext, offsets_local, cfg.sample_rate_hz,
                               decim, taps=taps_d,
                               start_index=_global_start(mesh, t_local,
                                                         halo))
    y = fir.fir_filter_same(y, taps_c)                         # (Cl, (T+2H)/D)
    return _shard_demod_tail(y, cfg, halo, t_local, mesh)


def _shard_step_fused(x_local: torch.Tensor, kernel: torch.Tensor,
                      z_rot: tuple, cfg: ReceiverConfig, halo: int, gc: int,
                      mesh: Mesh) -> ShardedResult:
    """Fused-conv variant of _shard_step: the block-ordered (2 C_local, 2,
    L) composite kernel of this rank's carriers as one stride-D conv
    (ops/fused._strided_conv), then the deferred per-carrier rotation on
    z (`z_rot`, its cos and sin): |y|^2 timing does not see the residual
    rotation, and symbols sps channel samples apart see it as one
    constant per carrier, so the global start drops out."""
    t_local = x_local.shape[-1]
    ext = extend_with_halo(x_local, halo, halo, mesh)          # (T+2H,)
    yr, yi = fused._strided_conv(ext, kernel, gc, cfg.decimation_factor)
    return _shard_demod_tail(torch.complex(yr, yi), cfg, halo, t_local, mesh,
                             z_rot=z_rot)


def _shard_demod_tail(y: torch.Tensor, cfg: ReceiverConfig, halo: int,
                      t_local: int, mesh: Mesh,
                      z_rot: tuple | None = None) -> ShardedResult:
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    # global best phase: the interior's phase power summed over time
    h_dec = halo // decim
    interior = y[:, h_dec:h_dec + t_local // decim]
    m_int = interior.shape[-1] // sps
    grid = interior[:, :m_int * sps].reshape(interior.shape[0], m_int, sps)
    best = _phase_best(grid.abs() ** 2, mesh)                  # (Cl,)
    symbols = _on_grid(y, best, sps)                           # (Cl, M_ext)

    if z_rot is None:
        hard = dqpsk.demodulate_hard(symbols, profile="ref")   # (Cl, M_ext-1)
    else:
        # the deferred rotation on z; a zero z quantizes to bin 0, as
        # the atan2 path puts it (models/multicarrier._demod_front)
        z = symbols[:, 1:] * symbols[:, :-1].conj()
        z = z * torch.complex(z_rot[0], -z_rot[1])[:, None]
        zr, zi = z.real, z.imag
        hard = torch.where((zr == 0) & (zi == 0), 0,
                           dqpsk.quantize_z_ref(zr, zi)).to(torch.uint8)
    bits = dqpsk.symbols_to_bits(hard)
    corr = sync.best_correlation(bits)
    return ShardedResult(bits[:, None], corr[:, None],
                         best.to(torch.int32)[:, None])


def _shard_step_realpair(x_ri: torch.Tensor, table: torch.Tensor,
                         taps_d: torch.Tensor, taps_c: torch.Tensor,
                         cfg: ReceiverConfig, halo: int,
                         mesh: Mesh) -> ShardedResult:
    """Complex-free shard step (models/realpair.py at pod scale): (2, T)
    local real-pair wideband + the (2, C_local, P) mixer table rolled
    for the halo (`realpair_shard_inputs`).  T and H are multiples of
    the table's period P, so every shard's extended block starts at the
    same phase (-H mod P) and one table serves all of them."""
    decim = cfg.decimation_factor
    sps = cfg.ref_samples_per_symbol
    t_local = x_ri.shape[-1]
    period = table.shape[-1]
    ext = extend_with_halo(x_ri, halo, halo, mesh)             # (2, T+2H)
    n_ext = t_local + 2 * halo

    # the mixer by the shard-invariant periodic table
    xt = ext.reshape(2, 1, n_ext // period, period)
    oc = table[0][:, None, :]                                  # (Cl, 1, P)
    osn = table[1][:, None, :]
    xr, xi = xt[0], xt[1]
    mr = (xr * oc - xi * osn).reshape(-1, n_ext)               # (Cl, T+2H)
    mi = (xr * osn + xi * oc).reshape(-1, n_ext)

    # the FIRs, aligned as models/realpair._realpair_block
    g1 = (len(taps_d) - 1) // 2
    g2 = (len(taps_c) - 1) // 2
    yr = _conv1d_real(_conv1d_real(mr, taps_d, decim, (g1, g1)), taps_c, 1,
                      (g2, g2))
    yi = _conv1d_real(_conv1d_real(mi, taps_d, decim, (g1, g1)), taps_c, 1,
                      (g2, g2))                                # (Cl, (T+2H)/D)

    # global best phase from the interior power summed over time
    h_dec = halo // decim
    int_r = yr[:, h_dec:h_dec + t_local // decim]
    int_i = yi[:, h_dec:h_dec + t_local // decim]
    m_int = int_r.shape[-1] // sps
    pw = int_r[:, :m_int * sps] ** 2 + int_i[:, :m_int * sps] ** 2
    best = _phase_best(pw.reshape(pw.shape[0], m_int, sps), mesh)

    # symbols on the global grid: a gather is the reference's one-hot
    # product exactly (x * 1 + 0 * others)
    sr, si = _on_grid(yr, best, sps), _on_grid(yi, best, sps)
    zr = sr[:, 1:] * sr[:, :-1] + si[:, 1:] * si[:, :-1]
    zi = si[:, 1:] * sr[:, :-1] - sr[:, 1:] * si[:, :-1]
    bits = dqpsk.symbols_to_bits(dqpsk.quantize_z_ref(zr, zi))
    corr = sync.best_correlation(bits)
    return ShardedResult(bits[:, None], corr[:, None],
                         best.to(torch.int32)[:, None])


def _staged_taps(cfg: ReceiverConfig, device: torch.device) -> tuple:
    """The decimating and channel FIR taps on `device`."""
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    return (torch.as_tensor(fir.design_decimation_fir(
                cfg.decimation_factor, cfg.decim_fir_taps_per_phase),
                device=device),
            torch.as_tensor(fir.design_channel_fir(cfg.channel_fir_taps,
                                                   cutoff), device=device))


def _default_halo(cfg: ReceiverConfig, halo: int | None, align: int) -> int:
    """The halo, by default the FIRs' group delays plus ~128 symbols of
    sync and frame span (132 symbols) rounded up to `align`."""
    if halo is None:
        step = cfg.decimation_factor * cfg.ref_samples_per_symbol
        halo = -(-(132 * step) // align) * align
    if halo % align:
        raise ValueError(f"halo {halo} is not a multiple of {align}")
    return halo


def build_sharded_step(mesh: Mesh, cfg: ReceiverConfig | None = None,
                       halo: int | None = None, *, device):
    """The staged sharded receive step of this rank.

    Returns fn(x_local, offsets_local) -> ShardedResult of this rank's
    segment (C_local, 1, ...): x_local (T,) complex64 and offsets_local
    (C_local,) float32 on `device`, as `shard_inputs` cuts them."""
    cfg = cfg or ReceiverConfig()
    device = _check_mesh(mesh, device)
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    halo = _default_halo(cfg, halo, step)
    taps_d, taps_c = _staged_taps(cfg, device)

    def run(x_local, offsets_local) -> ShardedResult:
        _check_block(x_local, device, step)
        return _shard_step(x_local, offsets_local, taps_d, taps_c, cfg, halo,
                           mesh)

    return run


def build_sharded_step_fused(mesh: Mesh, offsets_hz,
                             cfg: ReceiverConfig | None = None,
                             halo: int | None = None, *, device):
    """Fused-conv sharded step: the composite kernel of the carriers
    (ops/fused.py), cut along the carrier axis; its interiors equal the
    staged step's.

    Returns fn(x_local) -> ShardedResult of this rank's segment."""
    cfg = cfg or ReceiverConfig()
    device = _check_mesh(mesh, device)
    decim, sps = cfg.decimation_factor, cfg.ref_samples_per_symbol
    halo = _default_halo(cfg, halo, decim * sps)
    offs = np.asarray(offsets_hz, np.float64)
    cutoff = (cfg.channel_bandwidth_hz / 2) / (cfg.intermediate_rate_hz / 2)
    kernel, gc, rot = fused.fused_kernel(
        offs, cfg.sample_rate_hz, decim, cfg.decim_fir_taps_per_phase,
        cfg.channel_fir_taps, cutoff)
    c = len(offs)
    n_c = mesh.size(CARRIER_AXIS)
    if c % n_c:
        raise ValueError(f"{c} carriers do not split over {n_c} ranks")
    cl = c // n_c
    lo = mesh.index(CARRIER_AXIS) * cl
    # this rank's carriers in the block order [re_0..re_Cl, im_0..im_Cl]
    # of ops/fused.py
    kern_dev = torch.as_tensor(np.concatenate(
        [kernel[lo:lo + cl], kernel[c + lo:c + lo + cl]]).astype(np.float32),
        device=device)
    d = torch.as_tensor(np.asarray(rot, np.float32)[lo:lo + cl],
                        device=device) * float(decim * sps)
    d = 2.0 * math.pi * (d - torch.round(d))
    z_rot = (torch.cos(d), torch.sin(d))

    def run(x_local) -> ShardedResult:
        _check_block(x_local, device, decim * sps)
        return _shard_step_fused(x_local, kern_dev, z_rot, cfg, halo, gc,
                                 mesh)

    return run


def _shard_step_etsi(x_local: torch.Tensor, offsets_local: torch.Tensor,
                     taps_d: torch.Tensor, taps_r: np.ndarray,
                     cfg: ReceiverConfig, halo: int,
                     mesh: Mesh) -> ShardedEtsiResult:
    """etsi-profile shard step: channelize (K5 on a card) -> rational
    resample (x3/10, RRC) onto 4 samples per 18 kHz symbol -> global
    symbol timing summed over time -> soft demod.  T and H are multiples
    of decim x 10 x sps (400): decim x 10 keeps the resampler's output
    grid globally aligned, sps the 4-phase symbol grid."""
    decim = cfg.decimation_factor
    sps = cfg.etsi_sps
    t_local = x_local.shape[-1]
    ext = extend_with_halo(x_local, halo, halo, mesh)          # (T+2H,)
    y = channelizer.channelize(ext, offsets_local, cfg.sample_rate_hz,
                               decim, taps=taps_d,
                               start_index=_global_start(mesh, t_local,
                                                         halo))
    z = resample.rational_resample(y, 3, 10, taps_r)           # 72 kHz

    h_out = (halo // decim) * 3 // 10
    t_out = (t_local // decim) * 3 // 10
    interior = z[:, h_out:h_out + t_out]
    m_int = t_out // sps
    grid = interior[:, :m_int * sps].reshape(interior.shape[0], m_int, sps)
    best = _phase_best(grid.abs() ** 2, mesh)                  # (Cl,)
    symbols = _on_grid(z, best, sps)                           # (Cl, M_ext)

    llrs = dqpsk.demodulate_soft(symbols).soft_bits            # (Cl, M-1, 2)
    return ShardedEtsiResult(llrs.reshape(llrs.shape[0], -1)[:, None],
                             best.to(torch.int32)[:, None])


def _etsi_config(cfg: ReceiverConfig | None) -> ReceiverConfig:
    cfg = cfg or ReceiverConfig()
    return cfg if cfg.profile == "etsi" else dataclasses.replace(
        cfg, profile="etsi")


def build_sharded_step_etsi(mesh: Mesh, cfg: ReceiverConfig | None = None,
                            halo: int | None = None, *, device):
    """The etsi-profile sharded step (pod-scale downlink demod).

    Returns (fn, halo): fn(x_local, offsets_local) -> ShardedEtsiResult
    of this rank's segment; T_local and halo are multiples of 400."""
    cfg = _etsi_config(cfg)
    device = _check_mesh(mesh, device)
    align = cfg.decimation_factor * 10 * cfg.etsi_sps
    halo = _default_halo(cfg, halo, align)
    taps_d, _ = _staged_taps(cfg, device)
    taps_r = resample.design_rrc_resampler(3, 10, cfg.etsi_sps,
                                           cfg.rrc_alpha,
                                           cfg.rrc_span_symbols)

    def run(x_local, offsets_local) -> ShardedEtsiResult:
        _check_block(x_local, device, align)
        return _shard_step_etsi(x_local, offsets_local, taps_d, taps_r, cfg,
                                halo, mesh)

    return run, halo


def build_sharded_step_realpair(mesh: Mesh, cfg: ReceiverConfig | None = None,
                                halo: int | None = None,
                                spacing_hz: float = 25e3, *, device):
    """Complex-free sharded receive step.

    Returns (fn, halo): fn(x_ri_local, table_local) -> ShardedResult of
    this rank's segment, with x_ri_local (2, T) float32 and table_local
    (2, C_local, P) from `realpair_shard_inputs`.  T_local and halo are
    multiples of lcm(decim x sps, P): 6240 at the reference rates."""
    cfg = cfg or ReceiverConfig()
    device = _check_mesh(mesh, device)
    step = cfg.decimation_factor * cfg.ref_samples_per_symbol
    period = int(round(cfg.sample_rate_hz / spacing_hz))
    align = step * period // math.gcd(step, period)
    halo = _default_halo(cfg, halo, align)
    taps_d, taps_c = _staged_taps(cfg, device)

    def run(x_ri_local, table_local) -> ShardedResult:
        _check_block(x_ri_local, device, align)
        return _shard_step_realpair(x_ri_local, table_local, taps_d, taps_c,
                                    cfg, halo, mesh)

    return run, halo


def gather_result(mesh: Mesh, result):
    """A ShardedResult / ShardedEtsiResult of this rank's segment -> the
    same tuple of global (C, n_time, ...) arrays, on every rank."""
    return type(result)(*(gather_global(v, mesh) for v in result))


def _time_block(mesh: Mesh, x, device) -> torch.Tensor:
    """This rank's block of the last axis of x (numpy or tensor)."""
    x = torch.as_tensor(x)
    n_t, t = mesh.size(TIME_AXIS), mesh.index(TIME_AXIS)
    if x.shape[-1] % n_t:
        raise ValueError(f"{x.shape[-1]} samples do not split into {n_t} "
                         "time blocks")
    t_local = x.shape[-1] // n_t
    return x[..., t * t_local:(t + 1) * t_local].to(device).contiguous()


def _carrier_block(mesh: Mesh, a, axis: int = 0):
    """This rank's carriers along `axis` of a (numpy)."""
    a = np.asarray(a)
    n_c, c = mesh.size(CARRIER_AXIS), mesh.index(CARRIER_AXIS)
    if a.shape[axis] % n_c:
        raise ValueError(f"{a.shape[axis]} carriers do not split over {n_c} "
                         "carrier ranks")
    cl = a.shape[axis] // n_c
    return np.take(a, np.arange(c * cl, (c + 1) * cl), axis=axis)


def shard_inputs(mesh: Mesh, x, offsets, device) -> tuple:
    """This rank's inputs of build_sharded_step (and the etsi step): its
    time block of x (T_total,) as complex64 and its carriers' offsets as
    float32, on `device`."""
    xs = _time_block(mesh, torch.as_tensor(x).to(torch.complex64), device)
    offs = torch.as_tensor(_carrier_block(mesh, np.asarray(offsets,
                                                           np.float32)),
                           device=device)
    return xs, offs


def realpair_shard_inputs(mesh: Mesh, x, offsets, halo: int,
                          sample_rate_hz: float, spacing_hz: float = 25e3, *,
                          device) -> tuple:
    """This rank's inputs of build_sharded_step_realpair: its time block
    of the (2, T_total) real-pair wideband, and its carriers' rows of the
    mixer table rolled so that index j is global sample j - halo (every
    shard's extended block starts at -halo mod P)."""
    from tetraear_tpu_torch.models.realpair import mixer_table
    x = np.asarray(x)
    x_ri = (np.stack([x.real, x.imag]) if np.iscomplexobj(x) else x)
    base = mixer_table(np.asarray(offsets, np.float32), sample_rate_hz,
                       spacing_hz)
    table = np.roll(base, halo % base.shape[-1], axis=-1)
    return (_time_block(mesh, np.asarray(x_ri, np.float32), device),
            torch.as_tensor(_carrier_block(mesh, table, axis=1),
                            device=device))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class ShardedDownlinkReceiver:
    """Pod-scale ETSI downlink: the sharded etsi step, the global result
    gathered on every rank, its per-shard soft-bit segments stitched into
    one LLR stream per carrier, then the blind cell-acquisition walk
    (models/downlink.py) on each.

    Stitching: each time shard owns symbols [H_sym, H_sym + T_sym) of its
    extended segment; their soft bits concatenate exactly once into the
    global stream."""

    def __init__(self, mesh: Mesh, num_carriers: int,
                 cfg: ReceiverConfig | None = None,
                 halo: int | None = None,
                 traffic_channel: str = "TCH/S", traffic_depth: int = 1, *,
                 device):
        from tetraear_tpu_torch.models.downlink import DownlinkReceiver
        self.mesh = mesh
        self.device = torch.device(device)
        self.cfg = cfg or ReceiverConfig()
        self.run, self.halo = build_sharded_step_etsi(mesh, self.cfg, halo,
                                                      device=self.device)
        self.num_carriers = num_carriers
        self._cells = [DownlinkReceiver(None, traffic_channel, traffic_depth,
                                        device=self.device)
                       for _ in range(num_carriers)]

    def __call__(self, x, offsets) -> ShardedEtsiResult:
        """Wideband (T_total,) + (C,) offsets -> the global result."""
        xs, offs = shard_inputs(self.mesh, x, offsets, self.device)
        return gather_result(self.mesh, self.run(xs, offs))

    def stitch(self, result: ShardedEtsiResult, t_local: int) -> np.ndarray:
        """(C, n_time, seg) -> (C, global_bits) owned-region concatenation."""
        decim = self.cfg.decimation_factor
        sps = self.cfg.etsi_sps
        h_sym = ((self.halo // decim) * 3 // 10) // sps
        own_sym = ((t_local // decim) * 3 // 10) // sps
        soft = _host(result.soft_bits)
        c_total, n_time, seg = soft.shape
        lo = 2 * h_sym
        hi = lo + 2 * own_sym
        pieces = [soft[:, k, lo:hi] for k in range(n_time)]
        return np.concatenate(pieces, axis=-1)

    def decode(self, result: ShardedEtsiResult, t_local: int) -> list:
        """The global result -> per-carrier downlink frames (list of
        DownlinkFrame lists); t_local: samples per time shard."""
        llrs = self.stitch(result, t_local)
        return [self._cells[c].receive_soft(llrs[c])
                for c in range(self.num_carriers)]

    def receive(self, x, offsets) -> list:
        """Wideband (T_total,) + (C,) offsets -> per-carrier downlink
        frames (list of DownlinkFrame lists)."""
        t_local = np.shape(x)[-1] // self.mesh.size(TIME_AXIS)
        return self.decode(self(x, offsets), t_local)


class ShardedReceiver:
    """Pod-scale receive: the staged sharded step, the global result
    gathered on every rank, and host stitching of the per-shard extended
    segments into a global frame stream.

    Each time shard's segment covers its interior plus halo context;
    stitching keeps the frames whose sync hit lies in the shard's owned
    region (so every frame is emitted exactly once) and rebases frame
    numbers onto the global bit stream.  Fragmentation state flows
    through one stateful decoder per carrier, fed shards in time order."""

    def __init__(self, mesh: Mesh, cfg: ReceiverConfig | None = None,
                 halo: int | None = None, auto_decrypt: bool = False, *,
                 device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.cfg = cfg or ReceiverConfig()
        step = self.cfg.decimation_factor * self.cfg.ref_samples_per_symbol
        self.halo = _default_halo(self.cfg, halo, step)
        self.auto_decrypt = auto_decrypt
        self.run = build_sharded_step(mesh, self.cfg, self.halo,
                                      device=self.device)
        self._decoders = {}

    def __call__(self, x, offsets) -> ShardedResult:
        """Wideband (T_total,) + (C,) offsets -> the global result."""
        xs, offs = shard_inputs(self.mesh, x, offsets, self.device)
        return gather_result(self.mesh, self.run(xs, offs))

    def decode(self, result: ShardedResult, t_local: int) -> list:
        """result + per-shard input length -> list (per carrier) of frames.

        t_local: wideband samples per time shard (T_total / n_time)."""
        from tetraear_tpu_torch.core.decoder import TetraDecoder

        decim = self.cfg.decimation_factor
        sps = self.cfg.ref_samples_per_symbol
        halo_syms = (self.halo // decim) // sps
        own_syms = (t_local // decim) // sps
        halo_bits = 2 * halo_syms
        own_bits = 2 * own_syms

        bits_all = _host(result.bits)
        corr_all = _host(result.sync_corr)
        c_total, n_time = bits_all.shape[0], bits_all.shape[1]
        out = []
        for c in range(c_total):
            dec = self._decoders.setdefault(
                c, TetraDecoder(auto_decrypt=self.auto_decrypt,
                                device=self.device))
            frames_c = []
            for k in range(n_time):
                seg_bits = bits_all[c, k]
                mapped = ((seg_bits[0::2].astype(np.int64) << 1)
                          | seg_bits[1::2])
                frames = dec.decode_frontend(seg_bits, mapped, corr_all[c, k])
                base_bit = k * own_bits - halo_bits   # segment -> global
                for f in frames:
                    pos = f.get("sync_position")
                    if pos is None:
                        continue
                    # the owned region is [halo_bits, halo_bits + own_bits):
                    # positions below it map to global < 0 on shard 0 (zero-
                    # fill artifacts), to the neighbour's region otherwise
                    hi = halo_bits + own_bits if k < n_time - 1 else 1 << 60
                    if not (halo_bits <= pos < hi):
                        continue
                    global_start = pos - 216 + base_bit
                    f["number"] = int(global_start // 510)
                    f["timeslot"] = f["number"] % 4
                    f["sync_position"] = int(pos + base_bit)
                    f["carrier"] = c
                    f["time_shard"] = k
                    frames_c.append(f)
            out.append(frames_c)
        return out
