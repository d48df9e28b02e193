"""Continuous TETRA downlink (port of `tetraear_tpu.models.downlink`):
a TDMA multiframe transmitter and a cell-acquiring receiver over the true
ETSI burst structures.

A base-station downlink is a gapless pi/4-DQPSK stream of 510-bit slots:
SB bursts carrying BSCH (SYNC PDU) + SCH/HD (SYSINFO), NDB bursts carrying
SCH/F signalling or TCH traffic, and AACH on every burst.  The receiver
acquires it blind:

    soft bits --STS matched filter--> SB found
      -> BSCH decode (colour-code-0 scrambling) -> SYNC PDU
        -> cell scrambling seed (MCC/MNC/CC), slot grid, FN/MN/TN
          -> per slot: classify (STS vs NTS at bit 244), AACH (one
             RM(30,14) product for all slots), one batched channel decode
             per group (BSCH, SCH/HD, SCH/F, STCH, TCH) on the device,
             MAC / layer-3 parse on the host -> frames with TDMA coordinates

Every class takes an explicit `device`: the etsi demodulator, the AACH
product and the channel decodes run there; the burst walk, the PDU
dataclasses and the call ledger are host code, copies of the reference's.
`MulticarrierDownlinkReceiver` channelizes a wideband capture with
`ops.channelizer.channelize`, which is K5 on a CUDA tensor.
`simulate_multiframe` makes the `downlink --simulate` capture from seeds.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.config import ReceiverConfig
from tetraear_tpu_torch.core.calls import CallTracker
from tetraear_tpu_torch.models.receiver import as_iq
from tetraear_tpu_torch.models.receiver_etsi import (EtsiDemodResult,
                                                     EtsiReceiver)
from tetraear_tpu_torch.ops import channel_coding as cc
from tetraear_tpu_torch.ops import rm3014
from tetraear_tpu_torch.ops.scramble import (extended_colour_code,
                                             scrambling_sequence)
from tetraear_tpu_torch.protocol import bursts, cmce, layer3
from tetraear_tpu_torch.protocol import mac as mac_l2
from tetraear_tpu_torch.protocol import mle, sds_tl
from tetraear_tpu_torch.protocol.bits import bits_to_bytes, bytes_to_bits
from tetraear_tpu_torch.protocol.parser import TetraProtocolParser
from tetraear_tpu_torch.protocol.pdus import (AccessAssignPDU, SyncPDU,
                                              SysinfoPDU)
from tetraear_tpu_torch.utils import synth
from tetraear_tpu_torch.utils.metrics import record, span, tracing

SLOT_BITS = C.BITS_PER_SLOT                 # 510
SLOTS_PER_FRAME = C.SLOTS_PER_FRAME         # 4
FRAMES_PER_MF = C.FRAMES_PER_MULTIFRAME     # 18


# ---------------------------------------------------------------------------
# TDMA counting
# ---------------------------------------------------------------------------

def advance_tdma(tn: int, fn: int, mn: int, slots: int) -> Tuple[int, int, int]:
    """Advance (TN 1..4, FN 1..18, MN 1..60) by `slots` slots."""
    total = (tn - 1) + slots
    tn2 = total % SLOTS_PER_FRAME + 1
    frames = (fn - 1) + total // SLOTS_PER_FRAME
    fn2 = frames % FRAMES_PER_MF + 1
    mn2 = ((mn - 1) + frames // FRAMES_PER_MF) % 60 + 1
    return tn2, fn2, mn2


# ---------------------------------------------------------------------------
# Transmitter
# ---------------------------------------------------------------------------

@dataclass
class DownlinkConfig:
    mcc: int = 262
    mnc: int = 1001
    colour_code: int = 17
    location_area: int = 999
    main_carrier: int = 3600
    frequency_band: int = 3
    sync_timeslot: int = 1          # TN carrying SB every frame
    start_tn: int = 1
    start_fn: int = 1
    start_mn: int = 1

    @property
    def cell_ecc30(self) -> int:
        return extended_colour_code(self.mcc, self.mnc, self.colour_code)


@dataclass
class DownlinkFrame:
    """One decoded slot, with its TDMA coordinates."""
    slot_index: int               # slot position in the received stream
    tn: int
    fn: int
    mn: int
    burst_kind: str               # "SB" | "NDB"
    channel: str                  # "BSCH+SCH/HD" | "SCH/F" | "TCH/..."
    crc_ok: Optional[bool]        # None on pure-traffic slots (TCH carries
                                  # no block CRC — nothing was checked)
    aach: Optional[AccessAssignPDU]
    aach_margin: float
    sync_pdu: Optional[SyncPDU] = None
    sysinfo: Optional[SysinfoPDU] = None
    mac_bits: Optional[np.ndarray] = None
    mac_pdu: Optional[object] = None
    sds_message: Optional[str] = None
    call_metadata: Optional[object] = None
    tch_llrs: Optional[np.ndarray] = None   # raw 432 coded soft bits
    tch_bits: Optional[np.ndarray] = None   # depth-1 decoded traffic bits
    voice_block: Optional[bytes] = None     # TCH/S: 690-short codec block
    stolen: bool = False                    # NTS2: first half-slot = STCH
    layer3: Optional[List[object]] = None   # routed Layer3Result list
    encrypted: bool = False
    decrypted: bool = False
    decrypted_data: Optional[bytes] = None
    key_used: Optional[str] = None
    decrypt_score: int = 0

    def to_frame_dict(self) -> dict:
        """The frame-dict schema of the host decoder (its key set, plus
        etsi extras under additional_info), so that etsi downlink frames
        flow through the same JSONL recorder stack."""
        type_name = None
        if self.mac_pdu is not None:
            t = getattr(self.mac_pdu, "pdu_type", None)
            type_name = getattr(t, "name", None)
            if type_name:
                type_name = type_name.replace("_", "-")
        elif self.sync_pdu is not None:
            type_name = "BROADCAST"
        out = {
            "number": self.slot_index,
            "timeslot": self.tn - 1,
            "type_name": type_name or self.channel,
            # None (not False) on TCH slots: traffic channels carry no
            # block CRC, so consumers must not read a claimed pass/fail
            "burst_crc": (None if self.crc_ok is None
                          else bool(self.crc_ok)),
            "encrypted": self.encrypted and not self.decrypted,
            "decrypted": self.decrypted,
            "sds_message": self.sds_message,
            "best_score": self.decrypt_score,
            "key_used": self.key_used,
            "additional_info": {
                "profile": "etsi-downlink",
                "fn": self.fn, "mn": self.mn, "tn": self.tn,
                "burst": self.burst_kind, "channel": self.channel,
                "stolen": self.stolen,
                "aach_usage": (self.aach.downlink_usage
                               if self.aach else None),
            },
        }
        if self.sync_pdu is not None:
            out["additional_info"]["mcc"] = self.sync_pdu.mcc
            out["additional_info"]["mnc"] = self.sync_pdu.mnc
            out["additional_info"]["colour_code"] = \
                self.sync_pdu.colour_code
        if self.mac_pdu is not None:
            data = getattr(self.mac_pdu, "data", None)
            out["mac_pdu"] = {
                "address": getattr(self.mac_pdu, "address", None),
                "data": bytes(data).hex() if data else "",
            }
        if self.layer3:
            out["additional_info"]["layer3"] = [
                layer3.describe_pdu(r) for r in self.layer3]
        if self.call_metadata is not None:
            out["call_metadata"] = dataclasses.asdict(self.call_metadata)
        return out


class DownlinkTransmitter:
    """Build a gapless downlink bit/IQ stream, one 510-bit slot at a time."""

    def __init__(self, config: DownlinkConfig | None = None):
        self.cfg = config or DownlinkConfig()

    # --- coded building blocks ---
    def _sync_block(self, tn: int, fn: int, mn: int) -> np.ndarray:
        pdu = SyncPDU(colour_code=self.cfg.colour_code, timeslot=tn - 1,
                      frame_number=fn, multiframe_number=mn,
                      mcc=self.cfg.mcc, mnc=self.cfg.mnc)
        return cc.encode_channel(pdu.build(), "BSCH", ecc30=0)

    def _sysinfo_block(self) -> np.ndarray:
        pdu = SysinfoPDU(main_carrier=self.cfg.main_carrier,
                         frequency_band=self.cfg.frequency_band,
                         location_area=self.cfg.location_area)
        return cc.encode_channel(pdu.build(), "SCH/HD",
                                 ecc30=self.cfg.cell_ecc30)

    def _aach_block(self, fn: int, traffic: bool) -> np.ndarray:
        pdu = AccessAssignPDU(header=3 if traffic else 2,
                              field1=fn & 0x3F, field2=0)
        coded = rm3014.encode(pdu.build())
        seq = scrambling_sequence(self.cfg.cell_ecc30, 30)
        return coded ^ seq

    def slot_bits(self, tn: int, fn: int, mn: int,
                  mac_payload: Optional[np.ndarray] = None,
                  tch_coded: Optional[np.ndarray] = None,
                  stch: Optional[np.ndarray] = None) -> np.ndarray:
        """One 510-bit burst for TDMA position (tn, fn, mn).

        mac_payload: 268 type-1 bits for SCH/F; tch_coded: a 432-bit
        type-5 traffic block (already channel-coded, see encode_tch);
        stch: 124 type-1 STCH bits — *steals* the first half of a traffic
        slot (§9.5.2: NTS2 signals the stolen half-slot; the second half
        carries the first 216 bits of the traffic block); neither payload
        -> sync/idle schedule.
        """
        if tn == self.cfg.sync_timeslot:
            return bursts.build_sb(self._sync_block(tn, fn, mn),
                                   self._aach_block(fn, traffic=False),
                                   self._sysinfo_block())
        if tch_coded is not None:
            assert mac_payload is None, "slot carries SCH/F or TCH, not both"
            coded = np.asarray(tch_coded).astype(np.uint8)
            assert coded.size == 432
            if stch is not None:
                stolen = cc.encode_channel(stch, "STCH",
                                           ecc30=self.cfg.cell_ecc30)
                return bursts.build_ndb(stolen,
                                        self._aach_block(fn, traffic=True),
                                        coded[:216], training=2)
            return bursts.build_ndb(coded[:216],
                                    self._aach_block(fn, traffic=True),
                                    coded[216:], training=1)
        if mac_payload is None:
            k1, _ = cc.CHANNEL_GEOMETRY["SCH/F"]
            mac_payload = np.zeros(k1, np.uint8)      # null/idle block
        coded = cc.encode_channel(mac_payload, "SCH/F",
                                  ecc30=self.cfg.cell_ecc30)
        return bursts.build_ndb(coded[:216],
                                self._aach_block(fn, traffic=False),
                                coded[216:], training=1)

    # --- layer-3 signalling (protocol/{mle,cmce,mm,mac}.py) ---
    def signalling_blocks(self, pdu, ssi: int, pd: Optional[int] = None,
                          encryption_mode: int = 0, encryptor=None,
                          channel_allocation=None) -> List[np.ndarray]:
        """A CMCE/MM PDU -> one or more 268-bit SCH/F MAC blocks
        (MAC-RESOURCE, fragmented across MAC-FRAG/END when the TM-SDU
        exceeds one slot).  `ssi` is the layer-2 address (the group SSI
        for group-addressed signalling, §14.5.1.1).

        encryption_mode>0 encrypts the MLE TM-SDU with `encryptor`
        (crypto/tea.TEAEncryptor) before the MAC wrap — the receiver's
        brute-force path recovers it (test-pinned round trip)."""
        if pd is None:
            pd = (mle.PD.MM
                  if type(pdu).__module__.endswith(".mm") else mle.PD.CMCE)
        tm = mle.wrap_mle(pd, pdu.build())
        if encryption_mode:
            assert encryptor is not None, "encryption_mode needs encryptor"
            raw = bits_to_bytes(tm)
            if len(raw) % 8:
                raw += b"\x00" * (8 - len(raw) % 8)
            tm = bytes_to_bits(encryptor.encrypt(raw))
        first = mac_l2.MacResource(address=ssi,
                                   encryption_mode=encryption_mode,
                                   channel_allocation=channel_allocation)
        k1, _ = cc.CHANNEL_GEOMETRY["SCH/F"]
        return [block for _, block in mac_l2.fragment_tm_sdu(tm, k1, first)]

    def schedule_signalling(self, payloads: Dict[int, np.ndarray],
                            pdu, ssi: int, slot: int,
                            num_slots: int, tn: Optional[int] = None,
                            **kw) -> int:
        """Place a PDU's block(s) into a stream_bits payload dict starting
        at stream slot `slot`; fragments continue on the same TN (every
        SLOTS_PER_FRAME slots, the MAC channel axis §23.4.2).  Returns
        the next free slot index on that TN."""
        blocks = self.signalling_blocks(pdu, ssi, **kw)
        for i, b in enumerate(blocks):
            k = slot + i * SLOTS_PER_FRAME
            assert k < num_slots, "signalling does not fit in the stream"
            assert k not in payloads, f"slot {k} already scheduled"
            payloads[k] = b
        return slot + len(blocks) * SLOTS_PER_FRAME

    def stream_bits(self, num_slots: int,
                    payloads: Optional[Dict[int, np.ndarray]] = None,
                    tch_streams: Optional[Dict[int, Tuple[str, np.ndarray,
                                                          int]]] = None,
                    stch: Optional[Dict[int, np.ndarray]] = None
                    ) -> np.ndarray:
        """Concatenate `num_slots` slots starting at the configured TDMA
        origin.

        payloads: stream slot index -> 268 SCH/F type-1 bits.
        tch_streams: TN -> (channel, type1 blocks (M, k1), depth); that
        timeslot becomes a traffic channel, its blocks channel-coded
        (encode_tch, diagonal over `depth` bursts) and mapped to the TN's
        successive slots (one burst block per frame — the physical-channel
        axis the §8.2.4.2 interleaver runs along).  Frame 18 is the
        control frame (§9.3.2): traffic pauses there and the slot carries
        SCH/F signalling instead.
        stch: stream slot index -> 124 STCH type-1 bits stealing the
        first half of that traffic slot (NTS2 marks it on air).
        """
        payloads = payloads or {}
        tch_streams = tch_streams or {}
        stch = stch or {}
        coded_tch: Dict[int, List[np.ndarray]] = {}
        for t, (channel, blocks, depth) in tch_streams.items():
            assert t != self.cfg.sync_timeslot
            coded = cc.encode_tch(blocks, channel,
                                  ecc30=self.cfg.cell_ecc30, depth=depth)
            coded_tch[t] = list(coded)

        tn, fn, mn = self.cfg.start_tn, self.cfg.start_fn, self.cfg.start_mn
        out = []
        for k in range(num_slots):
            tch = None
            if fn != FRAMES_PER_MF and tn in coded_tch and coded_tch[tn]:
                tch = coded_tch[tn].pop(0)
            out.append(self.slot_bits(tn, fn, mn, payloads.get(k), tch,
                                      stch.get(k)))
            tn, fn, mn = advance_tdma(tn, fn, mn, 1)
        return np.concatenate(out) if out else np.zeros(0, np.uint8)

    def modulate(self, bits: np.ndarray,
                 sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                 snr_db: float | None = None, seed: int = 0,
                 lead_symbols: int = 12) -> np.ndarray:
        """Bit stream -> continuous-phase π/4-DQPSK IQ at `sample_rate`."""
        rng = np.random.default_rng(seed)
        lead = rng.integers(0, 2, 2 * lead_symbols).astype(np.uint8)
        syms = synth.bits_to_symbols(np.concatenate([lead, bits]))
        return synth.synthesize_iq(syms, sample_rate, snr_db=snr_db,
                                   mapping="pi4", seed=seed)


class SimulatedDownlink(NamedTuple):
    iq: np.ndarray          # complex64 at 2.4 MS/s
    cell: DownlinkConfig
    payloads: Dict[int, np.ndarray]   # stream slot -> 268 SCH/F type-1 bits
    traffic: np.ndarray     # (M, k1) type-1 blocks of the TN3 traffic
    voiced: bool            # the blocks are ACELP-coded speech


# the group call the simulated cell signals on TN4
SIM_GROUP, SIM_TALKER, SIM_CALL = 0x2328, 0x457, 41


def simulate_multiframe(slots: int = 16, message: str = "DOWNLINK SDS",
                        snr_db: float | None = 25.0,
                        traffic_channel: str = "TCH/S",
                        traffic_depth: int = 1, seed: int = 0,
                        start_mn: int = 1,
                        voice: bool = False) -> SimulatedDownlink:
    """The `downlink --simulate` capture: SB on TN1 every frame, SCH/F
    MAC blocks with SDS texts "<message> #<slot>" on TN2, a traffic
    channel on TN3 (SCH/F in frame 18), and on TN4 a group call's CMCE
    signalling (D-SETUP allocating TN3, D-TX-GRANTED, D-SDS-DATA with the
    SDS-TL text "<message> via SDS-TL", D-TX-CEASED, D-RELEASE), then
    idle SCH/F; `slots` slots from TN1 FN1 of multiframe `start_mn`.

    `seed` draws the blocks' fill bits and the random traffic bits, and
    seed + 1 the lead and the noise (`DownlinkTransmitter.modulate`;
    snr_db over the whole 2.4 MS/s band, as utils.synth.synthesize_iq).
    `voice` codes TCH/S as ACELP speech with the codec built from
    native/codec where it builds; random bits otherwise."""
    cell = DownlinkConfig(start_mn=start_mn)
    tx = DownlinkTransmitter(cell)
    rng = np.random.default_rng(seed)
    # a 268-bit SCH/F block fits 29 payload bytes after the 35-bit header
    payloads = {k: synth.make_mac_block_bits(
        f"{message} #{k}".encode()[:29], seed=(seed << 16) + k)
        for k in range(slots) if k % 4 == 1}
    talker = cmce.Address(1, SIM_TALKER)
    alloc = mac_l2.ChannelAllocation(allocation_type=1, timeslots=0b0010,
                                     carrier_number=cell.main_carrier)
    seq = [cmce.DSetup(call_identifier=SIM_CALL, call_priority=5,
                       transmission_grant=1, calling_party=talker),
           cmce.DTxGranted(call_identifier=SIM_CALL, transmission_grant=1,
                           transmitting_party=talker),
           cmce.DSdsData(calling_party=talker, short_data_type=3,
                         data_bits=sds_tl.build_text_transfer(
                             f"{message} via SDS-TL")),
           cmce.DTxCeased(call_identifier=SIM_CALL),
           cmce.DRelease(call_identifier=SIM_CALL, disconnect_cause=2)]
    slot = 3
    for pdu in seq:
        if slot >= slots:
            break
        kw = ({"channel_allocation": alloc}
              if isinstance(pdu, cmce.DSetup) else {})
        slot = tx.schedule_signalling(payloads, pdu, SIM_GROUP, slot, slots,
                                      **kw)
    k1 = cc.TCH_GEOMETRY[traffic_channel][0]
    voc = None
    if voice and traffic_channel == "TCH/S":
        from tetraear_tpu_torch.audio.voice import VoiceEncoder
        venc = VoiceEncoder()
        if venc.working:
            n_blocks = max(1, slots // 4)
            pcm = synth.make_test_speech(n_blocks * 0.06 + 0.06)
            voc = venc.encode_pcm_bits(pcm)[:n_blocks]
    voiced = voc is not None and len(voc) > 0
    if not voiced:
        voc = rng.integers(0, 2, (max(1, slots // 4), k1)).astype(np.uint8)
    bits = tx.stream_bits(slots, payloads=payloads,
                          tch_streams={3: (traffic_channel, voc,
                                           traffic_depth)})
    return SimulatedDownlink(tx.modulate(bits, snr_db=snr_db, seed=seed + 1),
                             cell, payloads, voc, voiced)


# ---------------------------------------------------------------------------
# Receiver
# ---------------------------------------------------------------------------

def _pattern_corr(hard_bits: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Match fraction of `pattern` at every stream position (host;
    acquisition runs once per stream, the per-slot path uses fixed
    offsets afterwards)."""
    n, m = hard_bits.size, pattern.size
    if n < m:
        return np.zeros(0, np.float32)
    x = hard_bits.astype(np.float32) * 2 - 1
    p = pattern.astype(np.float32) * 2 - 1
    out = np.correlate(x, p, mode="valid")
    return (m + out) / (2 * m)


class DownlinkReceiver:
    """Blind cell acquisition + slot-grid decode over a soft-bit stream.

    Under a profiler session (utils.metrics) `demodulate` is the chunk
    span `tetra.downlink.demod` and `decode` the chunk span
    `tetra.downlink`; inside the latter, the inner spans `dl.acquire`
    (STS matched filter and BSCH tries up to the anchor), `dl.aach`
    (the RM(30,14) product and the AACH parses), `dl.channel` (the
    batched channel decodes, their pulls included) and `dl.assemble` (the
    host loop in slot order: PDU and layer-3 parses, the call ledger),
    with the counters `dl.slots` (slots on the grid), `dl.crc_checked`
    and `dl.crc_passed` (frames whose CRC was checked, and passed)."""

    STS_THRESHOLD = 0.87          # >= 34/38 midamble bits (33/38 = .868)

    def __init__(self, config: ReceiverConfig | None = None,
                 traffic_channel: str = "TCH/S", traffic_depth: int = 1,
                 auto_decrypt: bool = False,
                 keys: Optional[Sequence[str]] = None, *, device):
        """traffic_channel/traffic_depth: how AACH-marked traffic slots are
        decoded (in a live system this arrives via call-setup signalling;
        here it is receiver configuration).  Depth-1 channels decode
        inline; deeper interleaving is resolved per-TN afterwards with
        decode_traffic_stream().

        auto_decrypt: run the reference-parity brute-force decrypt
        orchestrator (core/decoder.py) on encrypted MAC payloads; `keys`
        are user hex keys tried before the built-in common set.

        device: where the etsi demodulator, the AACH product and the
        channel decodes run."""
        self.device = torch.device(device)
        self.rx = EtsiReceiver(config, device=self.device)
        self.parser = TetraProtocolParser()
        self.traffic_channel = traffic_channel
        self.traffic_depth = traffic_depth
        self.last_cell_ecc: Optional[int] = None
        self.auto_decrypt = auto_decrypt
        self._decryptor = None
        if auto_decrypt:
            from tetraear_tpu_torch.core.decoder import TetraDecoder
            self._decryptor = TetraDecoder(auto_decrypt=True,
                                           device=self.device)
            if keys:
                self._decryptor.set_keys(list(keys))
        # layer-3 state: per-TN TM-SDU reassembly + CMCE call ledger +
        # MM group-attachment ledger (gssi -> last MM instruction)
        self._defrag: Dict[int, layer3.Defragmenter] = {}
        self.call_tracker = CallTracker()
        self.group_attachments: Dict[int, dict] = {}
        self.network_info: Optional[mle.DNwrkBroadcast] = None

    # --- bit-level entry (unit tests / hard-decision paths) ---
    def receive_bits(self, bits: np.ndarray) -> List[DownlinkFrame]:
        llrs = np.asarray(bits).astype(np.float32) * 2 - 1
        return self.receive_soft(llrs)

    def estimate_offset(self, iq, sample_rate_hz: float =
                        C.DEFAULT_SAMPLE_RATE_HZ,
                        search_hz: float = 20_000.0) -> float:
        """Carrier-offset estimate: linear-power spectral centroid over the
        search band (the frames' spectra on the receiver's device).  A
        TETRA emission is ~25 kHz of near-symmetric power, so the centroid
        tracks the shift directly; the DQPSK quantizer tolerates ~1 kHz of
        residual."""
        from tetraear_tpu_torch.ops import spectrum as sp
        n_fft = C.SPECTRUM_FFT_SIZE
        x = as_iq(np.asarray(iq[: (len(iq) // n_fft) * n_fft], np.complex64),
                  self.device)
        if x.shape[-1] < n_fft:
            return 0.0
        p_db = sp.spectrum_frames_dbfs(x, n_fft).cpu().numpy().mean(axis=0)
        freqs = sp.fft_freqs(n_fft, sample_rate_hz)
        mask = np.abs(freqs) <= search_hz
        p = 10.0 ** (p_db[mask] / 10.0)
        return float(np.sum(freqs[mask] * p) / max(np.sum(p), 1e-12))

    # --- IQ entry ---
    def receive(self, iq, freq_offset: float | str = 0.0
                ) -> List[DownlinkFrame]:
        return self.decode(self.demodulate(iq, freq_offset))

    def demodulate(self, iq, freq_offset: float | str = 0.0
                   ) -> EtsiDemodResult:
        """The device half of `receive`: the etsi demod of the capture,
        queued on the receiver's device with no host sync (an "auto"
        offset is estimated first, which reads the spectra back)."""
        with span("tetra.downlink.demod"):
            if freq_offset == "auto":
                freq_offset = self.estimate_offset(
                    iq, self.rx.config.sample_rate_hz)
            return self.rx(iq, freq_offset)

    def decode(self, result: EtsiDemodResult) -> List[DownlinkFrame]:
        """The host half of `receive`: the symbol count and the soft bits
        pulled, then `receive_soft`."""
        with span("tetra.downlink"):
            count = int(result.count)
            if count < 2:
                return []
            soft = result.soft_bits[:count - 1].reshape(-1).cpu().numpy()
            return self.receive_soft(soft)

    # --- core ---
    def receive_soft(self, llrs: np.ndarray) -> List[DownlinkFrame]:
        traced = tracing()
        t0 = time.perf_counter_ns() if traced else 0
        hard = (llrs > 0).astype(np.uint8)
        corr = _pattern_corr(hard, bursts.STS)
        if corr.size == 0:
            return []

        # acquisition: first STS hit above threshold with a decodable BSCH
        anchor = None
        sync_pdu = None
        for pos in np.flatnonzero(corr >= self.STS_THRESHOLD):
            start = int(pos) - bursts.MIDAMBLE_POS
            if start < 0 or start + SLOT_BITS > llrs.size:
                continue
            pdu = self._try_bsch(llrs[start:start + SLOT_BITS])
            if pdu is not None:
                anchor, sync_pdu = start, pdu
                break
        if traced:
            record("dl.acquire", time.perf_counter_ns() - t0, 1)
        if anchor is None:
            return []

        cell_ecc = extended_colour_code(sync_pdu.mcc, sync_pdu.mnc,
                                        sync_pdu.colour_code)
        self.last_cell_ecc = cell_ecc
        # back up to the earliest full slot on the grid
        first = anchor % SLOT_BITS if anchor >= SLOT_BITS else anchor
        slots_before = (anchor - first) // SLOT_BITS
        tn0, fn0, mn0 = sync_pdu.timeslot + 1, sync_pdu.frame_number, \
            sync_pdu.multiframe_number
        # TDMA coordinates of the first full slot (rewind the anchor's)
        back = slots_before
        tn0, fn0, mn0 = advance_tdma(
            tn0, fn0, mn0,
            -back % (SLOTS_PER_FRAME * FRAMES_PER_MF * 60))

        n_slots = (llrs.size - first) // SLOT_BITS
        slots = llrs[first:first + n_slots * SLOT_BITS] \
            .reshape(n_slots, SLOT_BITS).astype(np.float32)
        frames = self._decode_slots_batched(slots, cell_ecc, tn0, fn0, mn0)
        return frames

    # --- helpers ---
    def _try_bsch(self, slot_llrs: np.ndarray) -> Optional[SyncPDU]:
        lo, hi = bursts.SB_FIELDS["sb1"]
        dec = cc.decode_channel_soft(self._dev(slot_llrs[lo:hi]), "BSCH",
                                     ecc30=0)
        if not bool(dec.crc_ok):
            return None
        return SyncPDU.parse(dec.bits.cpu().numpy())

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host float32 array as a tensor on the receiver's device."""
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=self.device)

    def _decode_slots_batched(self, slots: np.ndarray, cell_ecc: int,
                              tn0: int, fn0: int,
                              mn0: int) -> List[DownlinkFrame]:
        """Decode all slots with a handful of batched device calls: one
        RM(30,14) product decodes every AACH in the capture, one batched
        Viterbi per channel group (BSCH, SCH/HD, SCH/F, STCH, TCH) covers
        all slots of that kind.  Host code only slices fields and
        assembles the (data-dependent) PDU results.
        """
        n = slots.shape[0]
        if n == 0:
            return []
        traced = tracing()
        clock = time.perf_counter_ns
        hard = (slots > 0).astype(np.uint8)

        # classification (vectorized host compare — trivially cheap)
        sts_score = (hard[:, 244:282] == bursts.STS).sum(1)
        n_score = (hard[:, 244:266] == bursts.NTS1).sum(1)
        p_score = (hard[:, 244:266] == bursts.NTS2).sum(1)
        is_sb = sts_score >= np.maximum(n_score, p_score) + 8

        # AACH for every slot: one (n, 30) x (30, 16384) matmul
        t0 = clock() if traced else 0
        bb = np.where(is_sb[:, None], slots[:, 214:244],
                      np.concatenate([slots[:, 230:244],
                                      slots[:, 266:282]], axis=1))
        seq = scrambling_sequence(cell_ecc, 30).astype(np.float32)
        aach_bits, margins = rm3014.decode_soft(self._dev(bb * (1 - 2 * seq)))
        aach_bits = aach_bits.cpu().numpy()
        margins = margins.cpu().numpy()
        aachs = [AccessAssignPDU.parse(aach_bits[i]) for i in range(n)]
        if traced:
            record("dl.aach", clock() - t0, 1)

        ndb_coded = np.concatenate([slots[:, 14:230], slots[:, 282:498]],
                                   axis=1)
        is_traffic = np.array([(not is_sb[i]) and
                               aachs[i].downlink_usage == "traffic"
                               for i in range(n)])
        # NTS2 (p) on a traffic slot = first half-slot stolen for STCH
        is_stolen = is_traffic & (p_score > n_score)
        sb_idx = np.flatnonzero(is_sb)
        schf_idx = np.flatnonzero(~is_sb & ~is_traffic)
        tch_idx = np.flatnonzero(is_traffic & ~is_stolen)
        stolen_idx = np.flatnonzero(is_stolen)

        # batched channel decodes (one per group)
        t0 = clock() if traced else 0
        sb_res = {}
        if sb_idx.size:
            bsch = cc.decode_channel_soft(
                self._dev(slots[sb_idx, 94:214]), "BSCH", ecc30=0)
            schd = cc.decode_channel_soft(
                self._dev(slots[sb_idx, 282:498]), "SCH/HD",
                ecc30=cell_ecc)
            sb_res = {"bsch_bits": bsch.bits.cpu().numpy(),
                      "bsch_ok": bsch.crc_ok.cpu().numpy(),
                      "schd_bits": schd.bits.cpu().numpy(),
                      "schd_ok": schd.crc_ok.cpu().numpy()}
        schf_res = {}
        if schf_idx.size:
            dec = cc.decode_channel_soft(
                self._dev(ndb_coded[schf_idx]), "SCH/F", ecc30=cell_ecc)
            schf_res = {"bits": dec.bits.cpu().numpy(),
                        "ok": dec.crc_ok.cpu().numpy()}
        tch_out = None
        if tch_idx.size and self.traffic_depth == 1:
            tch_out = cc.decode_tch_soft(
                self._dev(ndb_coded[tch_idx]), self.traffic_channel,
                ecc30=cell_ecc, depth=1).cpu().numpy()
        stolen_res = {}
        if stolen_idx.size:
            dec = cc.decode_channel_soft(
                self._dev(slots[stolen_idx, 14:230]), "STCH",
                ecc30=cell_ecc)
            stolen_res = {"bits": dec.bits.cpu().numpy(),
                          "ok": dec.crc_ok.cpu().numpy()}
        if traced:
            record("dl.channel", clock() - t0, 1)

        # host assembly in slot order
        t0 = clock() if traced else 0
        sb_pos = {int(s): j for j, s in enumerate(sb_idx)}
        schf_pos = {int(s): j for j, s in enumerate(schf_idx)}
        tch_pos = {int(s): j for j, s in enumerate(tch_idx)}
        stolen_pos = {int(s): j for j, s in enumerate(stolen_idx)}
        frames: List[DownlinkFrame] = []
        tn, fn, mn = tn0, fn0, mn0
        for i in range(n):
            aach = aachs[i]
            margin = float(margins[i])
            if i in sb_pos:
                j = sb_pos[i]
                sync_pdu = (SyncPDU.parse(sb_res["bsch_bits"][j])
                            if sb_res["bsch_ok"][j] else None)
                sysinfo = None
                crc_ok = bool(sb_res["schd_ok"][j]) and sync_pdu is not None
                if sb_res["schd_ok"][j]:
                    bits = sb_res["schd_bits"][j]
                    if tuple(bits[:4]) == (1, 0, 0, 0):
                        sysinfo = SysinfoPDU.parse(bits)
                frames.append(DownlinkFrame(
                    i, tn, fn, mn, "SB", "BSCH+SCH/HD", crc_ok, aach,
                    margin, sync_pdu=sync_pdu, sysinfo=sysinfo))
            elif i in tch_pos:
                frame = DownlinkFrame(
                    i, tn, fn, mn, "NDB", self.traffic_channel, None, aach,
                    margin, tch_llrs=ndb_coded[i])
                if tch_out is not None:
                    arr = tch_out[tch_pos[i]]
                    if self.traffic_channel == "TCH/S":
                        from tetraear_tpu_torch.audio.blocks import \
                            block_from_soft_llrs
                        frame.voice_block = block_from_soft_llrs(arr)
                    else:
                        frame.tch_bits = arr
                # call-following: the tracker state at this point in the
                # stream reflects all signalling before slot i, so a TN
                # allocated by an earlier D-SETUP attributes this traffic
                # to its call/talkgroup
                call = self.call_tracker.call_for_tn(tn)
                if call is not None:
                    frame.call_metadata = self.call_tracker._meta(
                        call, "traffic")
                frames.append(frame)
            elif i in stolen_pos:
                j = stolen_pos[i]
                crc_ok = bool(stolen_res["ok"][j])
                mac_bits = stolen_res["bits"][j]
                # remaining traffic half-slot: bkn2 carries the first 216
                # coded bits; the rest of the block is an erasure
                frame = DownlinkFrame(
                    i, tn, fn, mn, "NDB",
                    f"STCH+{self.traffic_channel}", crc_ok, aach, margin,
                    mac_bits=mac_bits, stolen=True,
                    tch_llrs=np.concatenate([slots[i, 282:498],
                                             np.zeros(216, np.float32)]))
                if not (crc_ok and mac_bits.any()
                        and self._apply_layer3(frame, mac_bits)):
                    if crc_ok:
                        try:
                            mac_pdu = self.parser.parse_mac_pdu(mac_bits)
                            data = getattr(mac_pdu, "data", None)
                            if data:
                                frame.sds_message = \
                                    self.parser.parse_sds_data(bytes(data))
                            frame.mac_pdu = mac_pdu
                        except Exception:
                            frame.mac_pdu = None
                frames.append(frame)
            else:
                j = schf_pos[i]
                crc_ok = bool(schf_res["ok"][j])
                mac_bits = schf_res["bits"][j]
                frame = DownlinkFrame(
                    i, tn, fn, mn, "NDB", "SCH/F", crc_ok, aach, margin,
                    mac_bits=mac_bits)
                # true layer 3 first (protocol/layer3.py); the ref-compat
                # heuristic MAC/SDS chain is the fallback for payloads
                # that don't validate as real MAC (e.g. the reference's
                # own synthetic layout)
                if not (crc_ok and mac_bits.any()
                        and self._apply_layer3(frame, mac_bits)):
                    if crc_ok and mac_bits.any():
                        try:
                            mac_pdu = self.parser.parse_mac_pdu(mac_bits)
                            data = getattr(mac_pdu, "data", None)
                            if data and not getattr(mac_pdu, "encrypted",
                                                    False):
                                frame.sds_message = \
                                    self.parser.parse_sds_data(bytes(data))
                            if mac_pdu is not None:
                                frame.call_metadata = \
                                    self.parser.parse_call_metadata(mac_pdu)
                            frame.mac_pdu = mac_pdu
                            frame.encrypted = bool(
                                getattr(mac_pdu, "encrypted", False))
                        except Exception:
                            frame.mac_pdu = None
                    if frame.encrypted and self._decryptor is not None:
                        self._try_decrypt(frame)
                frames.append(frame)
            tn, fn, mn = advance_tdma(tn, fn, mn, 1)
        if traced:
            checked = [f.crc_ok for f in frames if f.crc_ok is not None]
            record("dl.assemble", clock() - t0, 1,
                   {"dl.slots": n, "dl.crc_checked": len(checked),
                    "dl.crc_passed": sum(checked)})
        return frames

    # --- layer-3 consumption (etsi profile) ---
    def _apply_layer3(self, frame: DownlinkFrame, mac_bits) -> bool:
        """Try the true MAC->MLE->CMCE/MM route on a CRC-clean block.
        Returns True when the block validated as real layer 3 (the
        caller then skips the ref-compat heuristics)."""
        try:
            results = layer3.decode_mac_block(mac_bits)
        except ValueError:
            return False
        keep: List[object] = []
        handled = False
        for res in results:
            if res.fragment:
                keep.append(res)
                handled = True
                done = self._defrag.setdefault(
                    frame.tn, layer3.Defragmenter()).feed(res)
                if done is not None and done.confident:
                    keep.append(done)
                    self._consume_layer3(frame, done)
                continue
            mp = res.mac_pdu
            if mp is not None and res.pdu is None and \
                    getattr(mp, "encryption_mode", 0):
                keep.append(res)
                handled = True
                frame.encrypted = True
                if self._decryptor is not None:
                    self._decrypt_layer3(frame, res)
                continue
            if res.confident:
                keep.append(res)
                handled = True
                self._consume_layer3(frame, res)
        if handled:
            frame.layer3 = keep
        return handled

    def _consume_layer3(self, frame: DownlinkFrame,
                        res: "layer3.Layer3Result") -> None:
        """Fold one routed PDU into the frame + the call/group ledgers."""
        from tetraear_tpu_torch.protocol import mm
        addr = getattr(res.mac_pdu, "address", None)
        alloc = getattr(res.mac_pdu, "channel_allocation", None)
        meta = self.call_tracker.update(res.pdu, mac_address=addr,
                                        channel_allocation=alloc)
        if meta is not None:
            frame.call_metadata = meta
        if res.sds is not None and res.sds.text:
            frame.sds_message = res.sds.text
        if isinstance(res.pdu, mm.DAttachDetachGroupIdentity):
            for g in res.pdu.groups:
                self.group_attachments[g.gssi] = {
                    "attached": g.attach, "ssi": addr,
                    "class_of_usage": g.class_of_usage if g.attach else
                    None, "detach_reason": None if g.attach else
                    g.detach_reason}
        if isinstance(res.pdu, mle.DNwrkBroadcast):
            self.network_info = res.pdu

    def _candidate_keys(self):
        """(algorithm, key, label) candidates in the reference decrypt
        order: user keys first, then the built-in common sets."""
        for idx, (alg, key) in enumerate(self._decryptor.user_keys):
            yield alg, key, f"{alg} user_key_{idx}"
        for alg, keys in self._decryptor.common_keys.items():
            for idx, key in enumerate(keys):
                yield alg, key, f"{alg} common_key_{idx}"

    def _decrypt_layer3(self, frame: DownlinkFrame,
                        res: "layer3.Layer3Result") -> None:
        """Brute-force an encrypted TM-SDU.  Acceptance is *structural*:
        the plaintext must route to a known layer-3 PDU AND re-encode to
        the identical bit prefix (with an all-zero pad tail), stronger
        than the host decoder's printability scoring, which the heuristic
        path still uses."""
        from tetraear_tpu_torch.crypto.tea import TEADecryptor
        ct = bits_to_bytes(res.mac_pdu.tm_sdu)
        if len(ct) < 8 or len(ct) % 8:
            return
        for alg, key, label in self._candidate_keys():
            try:
                pt = TEADecryptor(key, alg).decrypt(ct)
            except Exception:
                continue
            pt_bits = bytes_to_bits(pt)
            try:
                routed = layer3.decode_tm_sdu(pt_bits)
            except ValueError:
                continue
            if not routed.confident:
                continue
            rebuilt = mle.wrap_mle(routed.pd, routed.pdu.build())
            if rebuilt.size > pt_bits.size or \
                    not np.array_equal(pt_bits[:rebuilt.size], rebuilt) or \
                    pt_bits[rebuilt.size:].any():
                continue
            routed.mac_pdu = res.mac_pdu
            res.pd, res.pdu, res.sds = routed.pd, routed.pdu, routed.sds
            frame.decrypted = True
            frame.decrypted_data = pt
            frame.key_used = label
            frame.decrypt_score = 1000      # structural acceptance
            self._consume_layer3(frame, routed)
            return

    def _try_decrypt(self, frame: DownlinkFrame) -> None:
        """Run the reference-parity brute-force orchestrator on an
        encrypted MAC payload and attach the outcome to the frame."""
        fd = {"number": frame.slot_index,
              "encryption_algorithm": "TEA1",
              "mac_pdu": {"data": bytes(frame.mac_pdu.data)}}
        self._decryptor._decrypt_frame(fd)
        frame.decrypt_score = int(fd.get("best_score", 0))
        frame.key_used = fd.get("key_used") or fd.get("best_key")
        if fd.get("decrypted"):
            frame.decrypted = True
            frame.decrypted_data = bytes.fromhex(fd["decrypted_bytes"])
            try:
                frame.sds_message = self.parser.parse_sds_data(
                    frame.decrypted_data.rstrip(b"\x00"))
            except Exception:
                pass

    def decode_traffic_stream(self, frames: Sequence[DownlinkFrame],
                              tn: int, cell_ecc: Optional[int] = None,
                              channel: Optional[str] = None,
                              depth: Optional[int] = None) -> np.ndarray:
        """Resolve an N-burst-interleaved traffic channel from the decoded
        slot sequence of one TN.  Returns (M, k1) bits (or (M, 432) soft
        values for TCH/S); missing/non-traffic slots become erasures."""
        channel = channel or self.traffic_channel
        depth = depth or self.traffic_depth
        if cell_ecc is None:
            cell_ecc = self.last_cell_ecc
        assert cell_ecc is not None, "no cell acquired yet"
        slots = [f for f in frames if f.tn == tn and f.tch_llrs is not None]
        if len(slots) < depth:
            return np.zeros((0, cc.TCH_GEOMETRY[channel][0]), np.uint8)
        stack = self._dev(np.stack([f.tch_llrs for f in slots]))
        return cc.decode_tch_soft(stack, channel, ecc30=cell_ecc,
                                  depth=depth).cpu().numpy()


# ---------------------------------------------------------------------------
# Multicarrier downlink: one wideband capture -> C independent cells, each
# blind-acquired.  On the device: the channelizer (K5 on a card) and the
# etsi demod tail batched over the carrier axis; on the host: each
# carrier's soft bits through its own DownlinkReceiver.
# ---------------------------------------------------------------------------

class MulticarrierDownlinkReceiver:
    def __init__(self, num_carriers: int,
                 config: ReceiverConfig | None = None,
                 spacing_hz: float = 25_000.0,
                 traffic_channel: str = "TCH/S", traffic_depth: int = 1, *,
                 device):
        from tetraear_tpu_torch.ops import channelizer, fir, resample
        base = config or ReceiverConfig()
        if base.profile != "etsi":
            base = dataclasses.replace(base, profile="etsi")
        self.cfg = base
        self.device = torch.device(device)
        self.num_carriers = num_carriers
        self.offsets = channelizer.carrier_grid(num_carriers, spacing_hz)
        self._cells = [DownlinkReceiver(base, traffic_channel,
                                        traffic_depth, device=self.device)
                       for _ in range(num_carriers)]
        self._offsets_dev = torch.as_tensor(self.offsets, device=self.device)
        self._taps_d = torch.as_tensor(
            fir.design_decimation_fir(base.decimation_factor,
                                      base.decim_fir_taps_per_phase),
            device=self.device)
        self._taps_r = resample.design_rrc_resampler(
            3, 10, base.etsi_sps, base.rrc_alpha, base.rrc_span_symbols)

    def demodulate(self, iq) -> Tuple[torch.Tensor, torch.Tensor]:
        """Wideband IQ -> per-carrier (soft bits (C, M-1, 2), counts (C,))
        on the device: `channelize` (K5 on a card; its plain mixer + FIR
        on the CPU), then the etsi tail batched over the carriers.  The
        reference's TPU path runs the same channelizer as a dense conv
        (`ops.fused.ddc_kernel`), with the same values."""
        from tetraear_tpu_torch.ops import channelizer, dqpsk, resample, \
            timing
        cfg = self.cfg
        chans = channelizer.channelize(as_iq(iq, self.device),
                                       self._offsets_dev, cfg.sample_rate_hz,
                                       cfg.decimation_factor, self._taps_d)
        z = resample.rational_resample(chans, 3, 10, self._taps_r)
        ts = timing.best_phase_pick(z, cfg.etsi_sps, step=1)
        return dqpsk.demodulate_soft(ts.symbols).soft_bits, ts.count

    def receive(self, iq) -> List[List[DownlinkFrame]]:
        """Wideband IQ -> per-carrier decoded downlink frames."""
        soft_bits, counts = self.demodulate(iq)
        counts = counts.cpu().numpy()
        soft_bits = soft_bits.cpu().numpy()
        out: List[List[DownlinkFrame]] = []
        for c in range(self.num_carriers):
            m = int(counts[c])
            if m < 2:
                out.append([])
                continue
            llrs = soft_bits[c, :m - 1].reshape(-1)
            out.append(self._cells[c].receive_soft(llrs))
        return out


@dataclass
class CellReport:
    """One cell found by a wideband survey."""
    carrier_index: int
    offset_hz: float
    mcc: int
    mnc: int
    colour_code: int
    location_area: Optional[int]
    main_carrier: Optional[int]
    slots_decoded: int
    crc_rate: float
    neighbours: List[int] = None    # carriers from D-NWRK-BROADCAST


def survey_cells(iq, num_carriers: int = 16,
                 spacing_hz: float = 25_000.0,
                 config: ReceiverConfig | None = None, *,
                 device) -> List[CellReport]:
    """Wideband cell survey: channelize the capture on `device`,
    blind-acquire every 25 kHz channel, and report each live cell's
    identity; one capture covers the whole span, every carrier at once."""
    rx = MulticarrierDownlinkReceiver(num_carriers, config, spacing_hz,
                                      device=device)
    per_carrier = rx.receive(iq)
    reports: List[CellReport] = []
    for c, frames in enumerate(per_carrier):
        sbs = [f for f in frames if f.sync_pdu is not None]
        if not sbs:
            continue
        sb = sbs[0]
        sysinfos = [f.sysinfo for f in frames if f.sysinfo is not None]
        checked = [f for f in frames if f.crc_ok is not None]
        crc_rate = (sum(f.crc_ok for f in checked) / len(checked)
                    if checked else 0.0)
        net = rx._cells[c].network_info
        reports.append(CellReport(
            carrier_index=c,
            offset_hz=float(rx.offsets[c]),
            mcc=sb.sync_pdu.mcc, mnc=sb.sync_pdu.mnc,
            colour_code=sb.sync_pdu.colour_code,
            location_area=(sysinfos[0].location_area if sysinfos else None),
            main_carrier=(sysinfos[0].main_carrier if sysinfos else None),
            slots_decoded=len(frames), crc_rate=crc_rate,
            neighbours=([n.main_carrier for n in net.neighbours]
                        if net is not None else None)))
    return reports
