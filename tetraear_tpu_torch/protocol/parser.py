"""TETRA protocol parser: PHY burst slicing, MAC PDU parse + fragmentation,
call metadata, SDS facade, statistics.

Behavioral parity with tetraear/core/protocol.py:142-800 and :1261-1300.
The burst-level math (bit expansion, CRC) has batched device twins in
ops/crc.py and ops/sync.py; this host class is the stateful, byte-oriented
layer the device results feed into (SURVEY.md §7 host/device split).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.ops.crc import soft_crc_check_host
from tetraear_tpu_torch.protocol import sds as sds_mod
from tetraear_tpu_torch.protocol.bits import (as_bit_array, bits_to_bytes,
                                        bits_to_uint, symbols_to_bit_pairs)
from tetraear_tpu_torch.protocol.lip import parse_lip
from tetraear_tpu_torch.protocol.types import (BurstType, CallMetadata, MacPDU,
                                         PDUType, TetraBurst)

logger = logging.getLogger(__name__)


class TetraProtocolParser:
    """Stateful protocol parser (one per receive channel)."""

    SYMBOLS_PER_SLOT = C.SYMBOLS_PER_SLOT
    SLOTS_PER_FRAME = C.SLOTS_PER_FRAME
    FRAMES_PER_MULTIFRAME = C.FRAMES_PER_MULTIFRAME
    MULTIFRAMES_PER_HYPERFRAME = C.MULTIFRAMES_PER_HYPERFRAME

    TRAINING_SEQUENCES = {k: list(v) for k, v in C.TRAINING_SEQUENCES_14.items()}
    SYNC_CONTINUOUS_DOWNLINK = list(C.SYNC_CONTINUOUS_DOWNLINK)
    SYNC_DISCONTINUOUS_DOWNLINK = list(C.SYNC_DISCONTINUOUS_DOWNLINK)

    PDUType = PDUType  # referenced by the decrypt scorer (decoder.py:765)

    def __init__(self):
        self.current_frame_number = 0
        self.current_multiframe = 0
        self.current_hyperframe = 0
        self.mcc: Optional[int] = None
        self.mnc: Optional[int] = None
        self.la = None
        self.colour_code: Optional[int] = None

        self.stats = {
            "total_bursts": 0,
            "crc_pass": 0,
            "crc_fail": 0,
            "clear_mode_frames": 0,
            "encrypted_frames": 0,
            "decrypted_frames": 0,
            "voice_calls": 0,
            "data_messages": 0,
            "control_messages": 0,
        }

        self.fragment_buffer = bytearray()
        self.fragment_metadata: Dict = {}

    # ------------------------------------------------------------------ PHY
    def parse_burst(self, symbols, slot_number: int = 0,
                    crc_ok: Optional[bool] = None) -> Optional[TetraBurst]:
        """Slice a 255-symbol burst (protocol.py:192-244).

        ``crc_ok`` lets the caller supply a device-computed CRC verdict
        (ops/crc.soft_crc_check_batch) to skip the host recompute; None
        falls back to the exact host check.
        """
        symbols = np.asarray(symbols)
        if len(symbols) < self.SYMBOLS_PER_SLOT:
            logger.warning("Insufficient symbols for burst: %d < %d",
                           len(symbols), self.SYMBOLS_PER_SLOT)
            return None
        burst_symbols = symbols[:self.SYMBOLS_PER_SLOT]
        bits = symbols_to_bit_pairs(burst_symbols)

        burst_type = self._detect_burst_type(bits)
        training_seq = self._extract_training_sequence(bits, burst_type)
        data_bits = self._extract_data_bits(bits, burst_type)
        if crc_ok is None:
            crc_ok = self._check_crc(data_bits)
        crc_ok = bool(crc_ok)

        self.stats["total_bursts"] += 1
        self.stats["crc_pass" if crc_ok else "crc_fail"] += 1

        return TetraBurst(
            burst_type=burst_type,
            slot_number=slot_number,
            frame_number=self.current_frame_number,
            training_sequence=training_seq,
            data_bits=data_bits,
            crc_ok=crc_ok,
            colour_code=self.colour_code or 0,
        )

    def _detect_burst_type(self, bits: np.ndarray) -> BurstType:
        """Sync burst iff a sync word sits at mid-burst (protocol.py:246-254)."""
        sync_pos = len(bits) // 2
        if self._check_sync_pattern(bits[sync_pos:sync_pos + 22]):
            return BurstType.Synchronization
        return BurstType.NormalDownlink

    def _check_sync_pattern(self, bits: np.ndarray) -> bool:
        if len(bits) < 22:
            return False
        match_cont = np.sum(bits[:22] == C.SYNC_CONTINUOUS_DOWNLINK) / 22
        match_disc = np.sum(bits[:22] == C.SYNC_DISCONTINUOUS_DOWNLINK) / 22
        return max(match_cont, match_disc) > 0.8

    def _extract_training_sequence(self, bits, burst_type) -> np.ndarray:
        if burst_type == BurstType.Synchronization:
            return bits[C.BURST_TRAINING_SYNC[0]:C.BURST_TRAINING_SYNC[1]]
        return bits[C.BURST_TRAINING[0]:C.BURST_TRAINING[1]]

    def _extract_data_bits(self, bits, burst_type) -> np.ndarray:
        if burst_type in (BurstType.NormalDownlink, BurstType.NormalUplink):
            return np.concatenate([bits[C.BURST_BLOCK1[0]:C.BURST_BLOCK1[1]],
                                   bits[C.BURST_BLOCK2[0]:C.BURST_BLOCK2[1]]])
        return bits

    def _check_crc(self, bits) -> bool:
        """Soft CRC-16 gate (protocol.py:292-329); exact host twin of the
        batched device kernel."""
        return soft_crc_check_host(bits)

    def _calculate_crc16(self, bits) -> np.ndarray:
        from tetraear_tpu_torch.ops.crc import crc16_bits_arr
        return crc16_bits_arr(bits)

    # ------------------------------------------------------------------ MAC
    def parse_mac_pdu(self, bits) -> Optional[MacPDU]:
        """Downlink MAC PDU parse with fragmentation (protocol.py:349-596)."""
        bits = as_bit_array(bits)
        if len(bits) < 8:
            return None

        pdu_type_int = (int(bits[0]) << 1) | int(bits[1])
        if pdu_type_int == 0:
            pdu_type = PDUType.MAC_RESOURCE
        elif pdu_type_int == 1:
            pdu_type = PDUType.MAC_FRAG
        elif pdu_type_int == 2:
            pdu_type = PDUType.MAC_BROADCAST
        else:
            pdu_type = PDUType.MAC_END

        encryption_mode_val = (int(bits[2]) << 1) | int(bits[3])
        encrypted = encryption_mode_val > 0

        address: Optional[int] = None
        length = 0
        data_bytes = b""
        fill_bit_ind = 0

        if pdu_type == PDUType.MAC_RESOURCE:
            fill_bit_ind = int(bits[4])
            pos = 5
            if len(bits) >= pos + 24:
                address = bits_to_uint(bits[pos:pos + 24])
                pos += 24
            else:
                return None
            if len(bits) >= pos + 6:
                length = bits_to_uint(bits[pos:pos + 6])
                pos += 6
            else:
                return None
            data_len_bits = length * 8
            if data_len_bits > len(bits) - pos + 16:
                return None
            if data_len_bits > 0 and len(bits) >= pos + data_len_bits:
                data_bits = bits[pos:pos + data_len_bits]
            else:
                data_bits = bits[pos:]
            data_bytes = bits_to_bytes(data_bits)
            # start of a (possibly fragmented) message
            self.fragment_buffer = bytearray(data_bytes)
            self.fragment_metadata = {"address": address, "encrypted": encrypted,
                                      "mode": encryption_mode_val}

        elif pdu_type == PDUType.MAC_FRAG:
            fill_bit_ind = int(bits[4])
            data_bytes = bits_to_bytes(bits[5:])
            self.fragment_buffer.extend(data_bytes)
            if self.fragment_metadata:
                encrypted = self.fragment_metadata.get("encrypted", False)
                address = self.fragment_metadata.get("address")

        elif pdu_type == PDUType.MAC_BROADCAST:
            broadcast_type = (int(bits[2]) << 1) | int(bits[3])
            pos = 4
            if broadcast_type == 0:  # SYSINFO: MCC(10) MNC(14) CC(6)
                if len(bits) >= pos + 30:
                    # QUIRK (protocol.py:483-494): parser state is assigned
                    # BEFORE the ITU-T E.212 sanity gate, so invalid values
                    # poison self.mcc/mnc even when the PDU is rejected —
                    # later frames' call metadata inherits them.  The
                    # sibling _parse_broadcast validates first.
                    self.mcc = bits_to_uint(bits[pos:pos + 10])
                    self.mnc = bits_to_uint(bits[pos + 10:pos + 24])
                    self.colour_code = bits_to_uint(bits[pos + 24:pos + 30])
                    if self.mcc < 200 or self.mcc > 799:
                        logger.debug("Invalid MCC %d in SYNC - not real TETRA",
                                     self.mcc)
                        return None
                    if self.mnc > 999:
                        logger.debug("Invalid MNC %d in SYNC - not real TETRA",
                                     self.mnc)
                        return None
                    logger.info("Valid TETRA SYNC: MCC=%d MNC=%d",
                                self.mcc, self.mnc)
                else:
                    return None
            data_bytes = bits_to_bytes(bits[pos:])

        else:  # MAC_END
            fill_bit_ind = int(bits[4])
            pos = 5
            if len(bits) >= pos + 6:
                length = bits_to_uint(bits[pos:pos + 6])
                pos += 6
            else:
                return None
            data_len_bits = length * 8
            if data_len_bits > len(bits) - pos + 16:
                return None
            if data_len_bits > 0 and len(bits) >= pos + data_len_bits:
                data_bits = bits[pos:pos + data_len_bits]
            else:
                data_bits = bits[pos:]
            data_bytes = bits_to_bytes(data_bits)
            self.fragment_buffer.extend(data_bytes)
            if self.fragment_metadata:
                encrypted = self.fragment_metadata.get("encrypted", False)
                address = self.fragment_metadata.get("address")

        self.stats["encrypted_frames" if encrypted else "clear_mode_frames"] += 1

        pdu = MacPDU(
            pdu_type=pdu_type,
            encrypted=encrypted,
            address=address,
            length=length,
            data=data_bytes,
            fill_bits=fill_bit_ind,
            encryption_mode=encryption_mode_val,
        )

        if pdu_type == PDUType.MAC_END:
            if self.fragment_buffer:
                pdu.reassembled_data = bytes(self.fragment_buffer)
                if self.fragment_metadata:
                    if not pdu.address:
                        pdu.address = self.fragment_metadata.get("address")
                    pdu.encrypted = self.fragment_metadata.get("encrypted", False)
                self.fragment_buffer = bytearray()
                self.fragment_metadata = {}
        elif pdu_type == PDUType.MAC_RESOURCE:
            # single-slot messages: tentatively expose own data as reassembly
            pdu.reassembled_data = bytes(data_bytes)

        return pdu

    # ------------------------------------------------------- call metadata
    def parse_call_metadata(self, mac_pdu: MacPDU) -> Optional[CallMetadata]:
        """protocol.py:597-621."""
        if not mac_pdu or len(mac_pdu.data) < 4:
            return None
        if mac_pdu.pdu_type == PDUType.MAC_RESOURCE:
            return self._parse_resource_assignment(mac_pdu)
        if mac_pdu.pdu_type == PDUType.MAC_U_SIGNAL:
            return self._parse_call_setup(mac_pdu)
        if mac_pdu.pdu_type == PDUType.MAC_BROADCAST:
            return self._parse_broadcast(mac_pdu)
        return None

    def _parse_resource_assignment(self, mac_pdu: MacPDU) -> Optional[CallMetadata]:
        """Heuristic field map (protocol.py:623-678)."""
        data = mac_pdu.data
        if len(data) < 8:
            return None
        call_type = "Group" if data[0] & 0x80 else "Individual"
        talkgroup_id = int.from_bytes(data[1:4], "big") & 0xFFFFFF
        channel_allocated = data[4] & 0x3F
        encryption_enabled = bool(data[5] & 0x80)
        call_priority = (data[5] >> 2) & 0x0F
        call_identifier = ((data[6] & 0x0F) << 10) | (data[7] << 2)
        source_ssi = None
        if len(data) > 10:
            for i in range(8, len(data) - 3):
                val = int.from_bytes(data[i:i + 3], "big") & 0xFFFFFF
                if val != talkgroup_id and 1000 < val < 16000000:
                    if val != 0xFFFFFF and val != 0:
                        source_ssi = val
                        break
        self.stats["control_messages"] += 1
        return CallMetadata(
            call_type=call_type,
            talkgroup_id=talkgroup_id,
            source_ssi=source_ssi,
            dest_ssi=None,
            channel_allocated=channel_allocated,
            call_identifier=call_identifier,
            call_priority=call_priority,
            mcc=self.mcc,
            mnc=self.mnc,
            encryption_enabled=encryption_enabled,
            encryption_algorithm="TEA1" if encryption_enabled else None,
        )

    def _parse_call_setup(self, mac_pdu: MacPDU) -> Optional[CallMetadata]:
        """protocol.py:680-725."""
        data = mac_pdu.data
        if len(data) < 12:
            return None
        source_ssi = int.from_bytes(data[0:3], "big") & 0xFFFFFF
        dest_ssi = int.from_bytes(data[3:6], "big") & 0xFFFFFF
        if data[6] & 0x80:
            call_type = "Voice"
            self.stats["voice_calls"] += 1
        else:
            call_type = "Data"
            self.stats["data_messages"] += 1
        encryption_enabled = bool(data[7] & 0x80)
        encryption_alg = None
        if encryption_enabled:
            alg_code = (data[7] >> 4) & 0x07
            encryption_alg = {1: "TEA1", 2: "TEA2", 3: "TEA3", 4: "TEA4"}.get(alg_code)
        return CallMetadata(
            call_type=call_type,
            talkgroup_id=dest_ssi if call_type == "Voice" else None,
            source_ssi=source_ssi,
            dest_ssi=dest_ssi,
            channel_allocated=None,
            call_identifier=None,
            call_priority=0,
            mcc=self.mcc,
            mnc=self.mnc,
            encryption_enabled=encryption_enabled,
            encryption_algorithm=encryption_alg,
        )

    def _parse_broadcast(self, mac_pdu: MacPDU) -> Optional[CallMetadata]:
        """D-MLE-SYNC-ish broadcast parse (protocol.py:727-784)."""
        data = mac_pdu.data
        if len(data) < 5:
            return None
        try:
            from tetraear_tpu_torch.protocol.bits import bytes_to_bits
            bits = bytes_to_bits(data)
            mcc = bits_to_uint(bits[0:10])
            mnc = bits_to_uint(bits[10:24])
            colour_code = bits_to_uint(bits[24:30])
            if mcc < 200 or mcc > 799:
                logger.debug("Invalid MCC %d - likely noise", mcc)
                return None
            if mnc > 999:
                logger.debug("Invalid MNC %d - likely noise", mnc)
                return None
            self.mcc, self.mnc, self.colour_code = mcc, mnc, colour_code
            logger.info("Decoded TETRA network: MCC=%d MNC=%d CC=%d",
                        mcc, mnc, colour_code)
            return CallMetadata(
                call_type="Broadcast",
                talkgroup_id=None,
                source_ssi=None,
                dest_ssi=None,
                channel_allocated=None,
                mcc=mcc,
                mnc=mnc,
                encryption_enabled=False,
            )
        except Exception:
            return None

    # ---------------------------------------------------------------- SDS
    def parse_sds_message(self, mac_pdu: MacPDU) -> Optional[str]:
        if mac_pdu.pdu_type not in (PDUType.MAC_DATA, PDUType.MAC_SUPPL):
            return None
        return self.parse_sds_data(mac_pdu.data)

    def parse_sds_data(self, data: bytes) -> Optional[str]:
        def bump():
            self.stats["data_messages"] += 1
        return sds_mod.parse_sds_data(data, on_message=bump)

    def parse_lip(self, data: bytes) -> Optional[str]:
        return parse_lip(data)

    # compat shims for the text helpers (protocol.py:1114, 1167, 1204, 1213)
    def _unpack_gsm7bit(self, data, septet_count=None, skip_bits=0):
        return sds_mod.unpack_gsm7(data, septet_count, skip_bits)

    def _unpack_gsm7bit_with_udh(self, data, septet_count=None):
        return sds_mod.unpack_gsm7_with_udh(data, septet_count)

    def _score_text(self, text):
        return sds_mod.score_text(text)

    def _is_valid_text(self, text, threshold=0.8):
        return sds_mod.is_valid_text(text, threshold)

    # -------------------------------------------------------------- voice
    def extract_voice_payload(self, mac_pdu: MacPDU) -> Optional[bytes]:
        """protocol.py:1239-1259."""
        if not mac_pdu.data:
            return None
        return mac_pdu.data

    # --------------------------------------------------------------- stats
    def get_statistics(self) -> Dict:
        """protocol.py:1261-1275."""
        total = self.stats["clear_mode_frames"] + self.stats["encrypted_frames"]
        if total > 0:
            clear_pct = self.stats["clear_mode_frames"] / total * 100
            enc_pct = self.stats["encrypted_frames"] / total * 100
        else:
            clear_pct = enc_pct = 0
        return {
            **self.stats,
            "clear_mode_percentage": clear_pct,
            "encrypted_percentage": enc_pct,
            "crc_success_rate": (self.stats["crc_pass"]
                                 / max(1, self.stats["total_bursts"])) * 100,
        }

    def format_call_metadata(self, metadata: CallMetadata) -> str:
        """protocol.py:1277-1300."""
        lines = [f"Call Type: {metadata.call_type}"]
        if metadata.talkgroup_id:
            lines.append(f"Talkgroup: {metadata.talkgroup_id}")
        if metadata.source_ssi:
            lines.append(f"Source SSI: {metadata.source_ssi}")
        if metadata.dest_ssi:
            lines.append(f"Dest SSI: {metadata.dest_ssi}")
        if metadata.channel_allocated:
            lines.append(f"Channel: {metadata.channel_allocated}")
        if metadata.encryption_enabled:
            lines.append(f"Encryption: {metadata.encryption_algorithm or 'Unknown'}")
        else:
            lines.append("Clear Mode (No Encryption)")
        return "\n".join(lines)
