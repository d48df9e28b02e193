"""TETRA frame decode orchestration.

Behavioral parity with tetraear/core/decoder.py (the *live* code paths: the
reference defines ``decode_frame`` twice and the second definition at
decoder.py:890 shadows the first — only the second's semantics exist here,
documented quirk per SURVEY.md §7).

The port's copy of the JAX package's host decoder.  Device/host split:
the dense TS1/TS2 sync correlation runs on the decoder's device
(`ops.sync.sync_correlation`, replacing the reference's per-position
Python loop, decoder.py:231-259); the data-dependent greedy walk,
adaptive thresholds, MAC parsing and decryption scoring stay host-side,
operating on the dense score arrays.  The scores are integers over 22 in
f32 on any device, so the frames do not depend on it.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.crypto.keys import COMMON_KEYS, TetraKeyManager, parse_user_keys
from tetraear_tpu_torch.crypto.tea import TEADecryptor
from tetraear_tpu_torch.protocol.bits import bits_to_binstr, bits_to_bytes
from tetraear_tpu_torch.ops.sync import sync_correlation
from tetraear_tpu_torch.protocol.parser import TetraProtocolParser

logger = logging.getLogger(__name__)


class TetraDecoder:
    """Decodes TETRA frames from demodulated symbols (decoder.py:16-34);
    the dense sync correlation runs on `device`."""

    def __init__(self, key_manager: Optional[TetraKeyManager] = None,
                 auto_decrypt: bool = True, *, device):
        self.device = torch.device(device)
        # 31-bit legacy pattern kept for API parity (decoder.py:28-29)
        self.SYNC_PATTERN = list(C.SCANNER_SYNC_PATTERN_31)
        self.FRAME_LENGTH = C.FRAME_LENGTH_BITS
        self.key_manager = key_manager
        self.auto_decrypt = auto_decrypt
        self.protocol_parser = TetraProtocolParser()
        self.common_keys = COMMON_KEYS
        self.user_keys: List[Tuple[str, bytes]] = []
        self.sync_patterns = {"TS1": np.asarray(C.TS1), "TS2": np.asarray(C.TS2)}

    # ------------------------------------------------------------------ keys
    def set_keys(self, keys) -> None:
        """Load user hex keys for brute-force (decoder.py:101-138)."""
        self.user_keys = parse_user_keys(list(keys))
        logger.info("Loaded %d user-provided encryption keys", len(self.user_keys))

    # ------------------------------------------------------------- symbols
    def symbols_to_bits(self, symbols) -> Tuple[np.ndarray, np.ndarray]:
        """Symbols -> (bits, mapped 0-3 symbols), handling both the 0-3
        dibit format and the legacy 0-7 8-PSK fold (decoder.py:140-169)."""
        symbols = np.asarray(symbols)
        if symbols.size == 0:
            return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
        if symbols.max() <= 3:
            vals = symbols.astype(np.int64) & 0x3
        else:
            lut = np.array([0, 0, 0, 1, 1, 3, 2, 2], dtype=np.int64)
            clipped = np.clip(symbols.astype(np.int64), 0, 7)
            vals = lut[clipped]
            vals[(symbols < 0) | (symbols > 7)] = 0
        bits = np.empty(vals.size * 2, dtype=np.int64)
        bits[0::2] = vals >> 1
        bits[1::2] = vals & 1
        return bits, vals

    # ---------------------------------------------------------------- sync
    def dense_sync(self, bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ts1_corr, ts2_corr) f32 at every window position, computed on
        the decoder's device."""
        b = torch.as_tensor(np.asarray(bits).astype(np.uint8),
                            device=self.device)
        corr = sync_correlation(b).cpu().numpy()
        return corr[0], corr[1]

    def find_sync(self, bits, threshold: float = 0.85,
                  return_max_corr: bool = False,
                  _dense: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """Greedy TS1/TS2 sync search with adaptive-threshold fallback.

        Exact reference semantics (decoder.py:171-295) driven by the dense
        device correlation: TS1 checked before TS2 at each position, accepted
        positions skip 250 bits ahead, ``max_corr`` only reflects values the
        reference's loop would have computed (TS2 is not evaluated at
        positions where TS1 already met the threshold).
        """
        bits = np.asarray(bits)
        sync_positions: List[int] = []
        if len(bits) < C.SYNC_LEN_BITS:
            return (sync_positions, 0.0) if return_max_corr else sync_positions

        ts1, ts2 = _dense if _dense is not None else self.dense_sync(bits)
        num_windows = len(ts1)
        if num_windows <= 0:
            return (sync_positions, 0.0) if return_max_corr else sync_positions

        found_mask = (ts1 >= threshold) | (ts2 >= threshold)
        # per-position values as the reference loop computes them:
        # TS2 is skipped when TS1 already >= threshold
        eff_best = np.where(ts1 >= threshold, ts1, np.maximum(ts1, ts2))

        # greedy walk with 250-bit skip, vectorized over candidate hits
        visited_edges: List[Tuple[int, int]] = []  # [start, end) visited runs
        i = 0
        cand = np.flatnonzero(found_mask)
        ci = 0
        while True:
            ci = np.searchsorted(cand, i)
            if ci >= len(cand):
                visited_edges.append((i, num_windows))
                break
            pos = int(cand[ci])
            visited_edges.append((i, pos + 1))
            sync_positions.append(pos)
            i = pos + C.SYNC_SKIP_BITS

        # reference max_corr over *visited* positions only
        max_corr = 0.0
        for s, e in visited_edges:
            if e > s and s < num_windows:
                max_corr = max(max_corr, float(eff_best[s:min(e, num_windows)].max()))

        used_adaptive = False
        adaptive_threshold = None
        if (not sync_positions and max_corr > C.SYNC_ADAPTIVE_FLOOR
                and max_corr >= threshold - C.SYNC_ADAPTIVE_WINDOW):
            adaptive_threshold = max(C.SYNC_ADAPTIVE_FLOOR,
                                     max_corr - C.SYNC_ADAPTIVE_TOLERANCE)
            if adaptive_threshold < threshold:
                # re-walk stored correlations (all positions were visited,
                # no skips happened) with dedup over +/-250 neighbourhoods
                sync_positions = []
                next_free = 0
                # all_correlations excludes zero-correlation positions
                for pos in np.flatnonzero(eff_best >= adaptive_threshold):
                    pos = int(pos)
                    if eff_best[pos] <= 0:
                        continue
                    if pos >= next_free:
                        sync_positions.append(pos)
                        next_free = pos + C.SYNC_SKIP_BITS
                used_adaptive = bool(sync_positions)

        if not sync_positions:
            logger.debug("No sync found at threshold %.4f. Max correlation: %.4f",
                         threshold, max_corr)
        elif used_adaptive and adaptive_threshold is not None:
            logger.debug("Found %d syncs at adaptive threshold %.4f "
                         "(max: %.4f, original: %.4f)", len(sync_positions),
                         adaptive_threshold, max_corr, threshold)
        else:
            logger.debug("Found %d syncs at threshold %.4f. Max correlation: %.4f",
                         len(sync_positions), threshold, max_corr)

        if return_max_corr:
            return sync_positions, max_corr
        return sync_positions

    # -------------------------------------------------------------- decode
    def decode(self, symbols) -> List[dict]:
        """Symbol stream -> decoded frame dicts (decoder.py:835-888):
        `decode_scored(sync_scores(symbols))`."""
        return self.decode_scored(self.sync_scores(symbols))

    def sync_scores(self, symbols):
        """The device half of `decode`: (bits, mapped symbols, dense
        TS1/TS2 scores computed on the decoder's device), or None for a
        stream shorter than a sync word.  The capture loop and the
        scanner run it outside the catch that guards the host half, so
        that a device fault ends their run."""
        bits, mapped_symbols = self.symbols_to_bits(symbols)
        if bits.size < C.SYNC_LEN_BITS:
            return None
        return bits, mapped_symbols, self.dense_sync(bits)

    def decode_scored(self, scored) -> List[dict]:
        """The host half of `decode`: the sync search and the frame decode
        on the result of `sync_scores` ([] for None)."""
        if scored is None:
            return []
        return self._decode_with_dense(*scored)

    def decode_frontend(self, bits, mapped_symbols, best_corr) -> List[dict]:
        """Decode from device-frontend outputs (bits + dense best-of-TS1/TS2
        correlation), skipping the host-side correlation dispatch.

        Passing (best, best) as the dense pair is exactly equivalent to the
        per-pattern arrays for every observable of find_sync: the accept
        condition is max-of-patterns >= threshold either way, and max_corr
        only ever differs at positions that were accepted anyway.
        """
        bits = np.asarray(bits)
        mapped_symbols = np.asarray(mapped_symbols)
        best_corr = np.asarray(best_corr, dtype=np.float64)
        if bits.size < C.SYNC_LEN_BITS:
            return []
        return self._decode_with_dense(bits, mapped_symbols,
                                       (best_corr, best_corr))

    def _decode_with_dense(self, bits, mapped_symbols, dense) -> List[dict]:
        """Shared threshold-cascade + frame-slicing body (decoder.py:843-888)."""
        sync_positions, max_corr = self.find_sync(
            bits, threshold=0.90, return_max_corr=True, _dense=dense)
        if not sync_positions:
            sync_positions, max_corr = self.find_sync(
                bits, threshold=0.85, return_max_corr=True, _dense=dense)
            if not sync_positions:
                sync_positions, max_corr = self.find_sync(
                    bits, threshold=0.80, return_max_corr=True, _dense=dense)
                if not sync_positions and max_corr >= C.SYNC_ADAPTIVE_FLOOR:
                    adaptive = max(C.SYNC_ADAPTIVE_FLOOR,
                                   max_corr - C.SYNC_ADAPTIVE_TOLERANCE)
                    sync_positions, _ = self.find_sync(
                        bits, threshold=adaptive, return_max_corr=True,
                        _dense=dense)

        frames = []
        for pos in sync_positions:
            start_pos = pos - C.SYNC_TO_FRAME_START_BITS
            if start_pos < 0:
                continue
            start_sym = start_pos // 2
            if start_sym + C.SYMBOLS_PER_SLOT > len(mapped_symbols):
                continue
            frame_symbols = mapped_symbols[start_sym:start_sym + C.SYMBOLS_PER_SLOT]
            frame_bits = bits[start_pos:start_pos + C.BITS_PER_SLOT]
            current_frame_num = start_pos // C.BITS_PER_SLOT
            frame = self.decode_frame(frame_bits, 0, frame_symbols,
                                      frame_number=current_frame_num)
            if frame:
                # extra (non-reference) key: the absolute sync-hit bit index
                # in this block's stream — the reference's 'position' field
                # is always 0 on the live path (quirk); shard stitching and
                # overlap dedup need the real offset
                frame["sync_position"] = int(pos)
                frames.append(frame)
                logger.info("Decoded frame %s (type: %s)",
                            frame["number"], frame["type"])
        return frames

    def decode_frame(self, bits, start_pos: int, symbols=None,
                     frame_number: int = 0) -> Optional[dict]:
        """Decode one 510-bit slot (the live definition, decoder.py:890-1119)."""
        bits = np.asarray(bits)
        if len(bits) < self.FRAME_LENGTH:
            return None
        frame_bits = bits
        header_bits = frame_bits[0:32]

        pdu_type_int = (int(frame_bits[0]) << 1) | int(frame_bits[1])
        encryption_mode_int = (int(frame_bits[2]) << 1) | int(frame_bits[3])
        frame_type = pdu_type_int

        additional_info: dict = {}
        if frame_type == 0:
            frame_type_name = "MAC-RESOURCE"
            additional_info["description"] = "Resource allocation"
        elif frame_type == 1:
            frame_type_name = "MAC-FRAG"
            additional_info["description"] = "Fragment"
        elif frame_type == 2:
            frame_type_name = "MAC-BROADCAST"
            additional_info["description"] = "Broadcast info"
        elif frame_type == 3:
            frame_type_name = "MAC-END/RES"
            additional_info["description"] = "End/Reserved"
        else:
            frame_type_name = f"Type {frame_type}"
            additional_info["description"] = f"Raw type {frame_type}"

        encrypted = encryption_mode_int > 0
        encryption_algorithm = None
        if encryption_mode_int == 1:
            encryption_algorithm = "TEA1"
            additional_info["encryption_mode"] = "Class 2 (SCK)"
        elif encryption_mode_int == 2:
            encryption_algorithm = "TEA2"
            additional_info["encryption_mode"] = "Class 3 (DCK)"
        elif encryption_mode_int == 3:
            encryption_algorithm = "TEA3"
            additional_info["encryption_mode"] = "Reserved"

        frame_data = {
            "type": frame_type,
            "type_name": frame_type_name,
            "number": frame_number,
            "timeslot": frame_number % 4,
            "bits": frame_bits,
            "header": bits_to_binstr(header_bits),
            "position": start_pos,
            "encrypted": encrypted,
            "encryption_algorithm": encryption_algorithm,
            "key_id": "0",
            "additional_info": additional_info,
        }

        try:
            if symbols is None:
                pairs = frame_bits[:len(frame_bits) - len(frame_bits) % 2]
                symbols = (pairs[0::2].astype(np.int64) << 1) | pairs[1::2]
            burst = self.protocol_parser.parse_burst(
                np.asarray(symbols), slot_number=frame_number % 4)
            if burst:
                frame_data["burst_crc"] = burst.crc_ok
                try:
                    mac_pdu = self.protocol_parser.parse_mac_pdu(burst.data_bits)
                    if mac_pdu:
                        frame_data["mac_pdu"] = {
                            "type": mac_pdu.pdu_type.name,
                            "encrypted": mac_pdu.encrypted,
                            "address": mac_pdu.address,
                            "length": mac_pdu.length,
                            "data": mac_pdu.data,
                        }
                        if mac_pdu.encrypted:
                            encrypted = True
                            frame_data["encrypted"] = True
                            enc_mode = getattr(mac_pdu, "encryption_mode", 0)
                            if enc_mode == 1:
                                frame_data["encryption_algorithm"] = "TEA1"
                                additional_info["encryption_mode"] = "Class 2 (SCK)"
                            elif enc_mode == 2:
                                frame_data["encryption_algorithm"] = "TEA2"
                                additional_info["encryption_mode"] = "Class 3 (DCK)"
                            elif enc_mode == 3:
                                frame_data["encryption_algorithm"] = "TEA3"
                                additional_info["encryption_mode"] = "Reserved"
                            elif not frame_data.get("encryption_algorithm"):
                                frame_data["encryption_algorithm"] = "TEA1"
                        else:
                            # entropy double-check before trusting the clear
                            # flag (decoder.py:1037-1053)
                            if len(mac_pdu.data) > 0:
                                unique_bytes = len(set(mac_pdu.data))
                                total = len(mac_pdu.data)
                                if unique_bytes / max(total, 1) > 0.7 and total > 8:
                                    frame_data["encrypted"] = True
                                else:
                                    frame_data["encrypted"] = False
                                    frame_data["encryption_algorithm"] = None
                            else:
                                frame_data["encrypted"] = False
                                frame_data["encryption_algorithm"] = None

                        call_meta = self.protocol_parser.parse_call_metadata(mac_pdu)
                        if call_meta:
                            frame_data["call_metadata"] = {
                                "call_type": call_meta.call_type,
                                "talkgroup_id": call_meta.talkgroup_id,
                                "source_ssi": call_meta.source_ssi,
                                "dest_ssi": call_meta.dest_ssi,
                                "channel": call_meta.channel_allocated,
                                "call_identifier": call_meta.call_identifier,
                                "priority": call_meta.call_priority,
                                "mcc": call_meta.mcc,
                                "mnc": call_meta.mnc,
                                "encryption": call_meta.encryption_enabled,
                                "encryption_alg": call_meta.encryption_algorithm,
                            }
                            if call_meta.talkgroup_id:
                                additional_info["talkgroup"] = call_meta.talkgroup_id
                            if call_meta.source_ssi:
                                additional_info["source_ssi"] = call_meta.source_ssi
                            if call_meta.mcc:
                                additional_info["mcc"] = call_meta.mcc
                            if call_meta.mnc:
                                additional_info["mnc"] = call_meta.mnc

                        payload_to_decode = (mac_pdu.reassembled_data
                                             if mac_pdu.reassembled_data
                                             else mac_pdu.data)
                        if not mac_pdu.encrypted and len(payload_to_decode) > 0:
                            sds_text = self.protocol_parser.parse_sds_data(
                                payload_to_decode)
                            # NOTE startswith("[BIN]") deliberately does NOT
                            # exclude "[BIN-ENC]..." (reference quirk,
                            # decoder.py:1085)
                            if sds_text and not sds_text.startswith("[BIN]"):
                                frame_data["sds_message"] = sds_text
                                frame_data["decoded_text"] = sds_text
                                additional_info["sds_text"] = sds_text[:50]
                                if mac_pdu.reassembled_data:
                                    frame_data["is_reassembled"] = True
                                    additional_info["description"] += " (Reassembled)"
                    else:
                        # strict discard: unparseable MAC + failed CRC
                        if not burst.crc_ok:
                            return None
                except Exception as e:
                    logger.debug("MAC PDU parsing error: %s", e)
                    if not burst.crc_ok:
                        return None
        except Exception as e:
            logger.debug("Protocol parsing error: %s", e)

        if frame_data.get("encrypted") and (self.key_manager or self.auto_decrypt):
            frame_data = self._decrypt_frame(frame_data)
            if frame_data.get("decrypted") and "decrypted_bytes" in frame_data:
                try:
                    decrypted_bytes = bytes.fromhex(frame_data["decrypted_bytes"])
                    sds_text = self.protocol_parser.parse_sds_data(decrypted_bytes)
                    if sds_text:
                        frame_data["sds_message"] = sds_text
                        frame_data["decoded_text"] = sds_text
                        additional_info["sds_text"] = sds_text[:50]
                except Exception:
                    pass

        return frame_data

    # ------------------------------------------------------------- decrypt
    def _decrypt_frame(self, frame_data: dict) -> dict:
        """Brute-force decrypt with scored acceptance (decoder.py:576-833).

        Key order: user keys (matching algorithm) -> key-file key -> built-in
        common keys -> BYPASS -> user cross-algorithm keys -> first-5 common
        keys of each other algorithm.  Scoring and the >=80 acceptance gate
        replicate the reference exactly, including the shared-parser side
        effects (scoring attempts run through the same protocol parser and
        thus touch its fragmentation/stat state — documented quirk).
        """
        algorithm = frame_data.get("encryption_algorithm") or "TEA1"
        key_id = frame_data.get("key_id", "0")

        frame_data["decryption_attempted"] = True
        frame_data["keys_tried"] = 0
        frame_data["best_score"] = 0
        frame_data["best_key"] = None

        payload_bytes = None
        mac_pdu = frame_data.get("mac_pdu")
        if isinstance(mac_pdu, dict) and "data" in mac_pdu:
            pdu_data = mac_pdu.get("data")
            if isinstance(pdu_data, (bytes, bytearray)):
                payload_bytes = bytes(pdu_data)
            elif isinstance(pdu_data, str):
                try:
                    payload_bytes = bytes.fromhex(pdu_data)
                except Exception:
                    payload_bytes = None
        if payload_bytes is None:
            try:
                payload_bytes = bits_to_bytes(frame_data["bits"][32:])
            except Exception as e:
                frame_data["decrypted"] = False
                frame_data["decryption_error"] = f"Invalid payload format: {e}"
                return frame_data

        if len(payload_bytes) < 8:
            frame_data["decrypted"] = False
            frame_data["decryption_error"] = "Payload too short for decryption"
            return frame_data
        if len(payload_bytes) % 8 != 0:
            payload_bytes += b"\x00" * (8 - len(payload_bytes) % 8)

        keys_to_try: List[tuple] = []
        if self.key_manager and self.key_manager.has_key(algorithm, key_id):
            key = self.key_manager.get_key(algorithm, key_id)
            keys_to_try.append((key, f"{algorithm} key_id={key_id} (from file)"))
            logger.info("Trying key from file for %s", algorithm)

        user_keys_primary = []
        user_keys_cross = []
        for idx, (key_alg, key) in enumerate(self.user_keys):
            if key_alg == algorithm:
                user_keys_primary.append(
                    (key, f"{key_alg} user_key_{idx} (loaded)", key_alg))
            else:
                user_keys_cross.append(
                    (key, f"{key_alg} user_key_{idx} (cross-try)", key_alg))
        keys_to_try[0:0] = user_keys_primary

        if algorithm in self.common_keys:
            for idx, common_key in enumerate(self.common_keys[algorithm]):
                keys_to_try.append((common_key, f"{algorithm} common_key_{idx}"))

        keys_to_try.append((None, "BYPASS (Treat as Clear)"))
        keys_to_try.extend(user_keys_cross)
        for other_alg in ["TEA1", "TEA2", "TEA3", "TEA4"]:
            if other_alg != algorithm and other_alg in self.common_keys:
                for idx, common_key in enumerate(self.common_keys[other_alg][:5]):
                    keys_to_try.append(
                        (common_key, f"{other_alg} common_key_{idx} (cross-try)",
                         other_alg))

        if not keys_to_try:
            frame_data["decrypted"] = False
            frame_data["decryption_error"] = "No keys available"
            logger.warning("No keys available for decryption")
            return frame_data

        frame_data["keys_tried"] = len(keys_to_try)
        logger.info("Trying %d keys for frame %s", len(keys_to_try),
                    frame_data["number"])

        # Native fast path: decrypt the payload under every real key in one
        # C++ call (crypto/native.py); scoring stays in Python so results
        # are identical.  Falls back silently to the pure-Python Feistel.
        native_plain = {}
        try:
            from tetraear_tpu_torch.crypto import native as _native
            pairs = []
            pair_idx = []
            for i, item in enumerate(keys_to_try):
                key = item[0]
                alg = (item[2] if len(item) == 3 else algorithm) or algorithm
                if key is not None:
                    pairs.append((key, alg))
                    pair_idx.append(i)
            if pairs:
                results = _native.bruteforce(pairs, payload_bytes)
                if results is not None:
                    native_plain = dict(zip(pair_idx, results))
        except Exception:
            native_plain = {}

        best_result = None
        best_score = 0
        for idx, item in enumerate(keys_to_try):
            if len(item) == 3:
                key, key_desc, alg_to_use = item
            else:
                key, key_desc = item
                alg_to_use = algorithm
            try:
                if key is None:
                    decrypted_payload = payload_bytes
                elif idx in native_plain:
                    decrypted_payload = native_plain[idx]
                    if decrypted_payload is None:
                        # invalid key length — mirrors the ValueError the
                        # Python TEADecryptor raises (key counted, not scored)
                        continue
                else:
                    decryptor = TEADecryptor(key, alg_to_use or algorithm)
                    decrypted_payload = decryptor.decrypt(payload_bytes)
                score = self._score_decrypt(decrypted_payload)
                if score > best_score:
                    best_score = score
                    best_result = (decrypted_payload, key_desc)
                    frame_data["best_score"] = best_score
                    frame_data["best_key"] = key_desc
                if score > C.DECRYPT_EARLY_BREAK_SCORE:
                    logger.info("Good decryption score %d with %s", score, key_desc)
                    break
            except Exception as e:
                logger.debug("Key %s failed: %s", key_desc, e)
                continue

        if best_result and best_score >= C.DECRYPT_ACCEPT_SCORE:
            decrypted_payload, key_desc = best_result
            if str(key_desc).startswith("BYPASS"):
                frame_data["bypass_clear"] = True
                frame_data["encrypted"] = False
                frame_data["encryption_algorithm"] = None
                frame_data["decrypted"] = False
                frame_data["decryption_error"] = None
                frame_data["best_score"] = best_score
                frame_data["best_key"] = key_desc
                logger.info("[OK] Frame %s treated as clear (BYPASS) (score: %s)",
                            frame_data.get("number"), best_score)
                return frame_data

            frame_data["decrypted"] = True
            frame_data["decrypted_payload"] = "".join(
                format(b, "08b") for b in decrypted_payload)
            frame_data["decrypted_bytes"] = decrypted_payload.hex()
            frame_data["key_used"] = key_desc
            frame_data["decrypt_confidence"] = best_score
            frame_data["best_score"] = best_score
            frame_data["best_key"] = key_desc
            for alg in ("TEA1", "TEA2", "TEA3", "TEA4"):
                if alg in key_desc:
                    frame_data["encryption_algorithm"] = alg
                    break
            logger.info("[OK] Decrypted frame %s using %s (confidence: %d)",
                        frame_data["number"], key_desc, best_score)
        else:
            frame_data["decrypted"] = False
            frame_data["decryption_error"] = (
                f"Tried {len(keys_to_try)} key(s), best score: {best_score}")
            frame_data["best_score"] = best_score
            logger.debug("All keys failed for frame %s, best score: %d",
                         frame_data["number"], best_score)
        return frame_data

    def _score_decrypt(self, decrypted_payload: bytes) -> int:
        """Candidate-plaintext scoring (decoder.py:698-768)."""
        score = 0
        printable_count = sum(1 for b in decrypted_payload if 32 <= b <= 126)
        score += printable_count * 2
        unique_bytes = len(set(decrypted_payload))
        if unique_bytes > len(decrypted_payload) // 8:
            score += 30
        if decrypted_payload == b"\x00" * len(decrypted_payload):
            score -= 50
        if decrypted_payload == b"\xFF" * len(decrypted_payload):
            score -= 50
        if len(decrypted_payload) >= 4:
            first = decrypted_payload[0]
            if first != 0 and first != 0xFF:
                score += 10
            if first in (0x01, 0x02, 0x03, 0x04, 0x05, 0x08, 0x0A, 0x0C):
                score += 20
        if unique_bytes > 1:
            score += 10
        try:
            sds_text = self.protocol_parser.parse_sds_data(decrypted_payload)
            if sds_text:
                if sds_text.startswith("[BIN-ENC]"):
                    score -= 20
                elif sds_text.startswith("[BIN]"):
                    score += 40
                else:
                    score += 120
        except Exception:
            pass
        try:
            decrypted_bits = np.unpackbits(
                np.frombuffer(decrypted_payload, dtype=np.uint8))
            if self.protocol_parser._check_crc(decrypted_bits):
                score += 100
            # Reference quirk (decoder.py:763-766, pinned by the encrypted
            # golden fixture): the reference's "+50 if it parses as a
            # non-MAC-DATA PDU" bonus NEVER fires — it spells the enum as
            # `self.protocol_parser.PDUType`, which doesn't exist (PDUType
            # is module-level in protocol.py:54), so when the PDU parses
            # the comparison raises AttributeError into the bare `except`.
            # When the PDU is None the short-circuit skips the bonus too.
            # The parse call itself must stay: it mutates the shared
            # parser's fragment-reassembly state, which later frames see.
            self.protocol_parser.parse_mac_pdu(decrypted_bits)
        except Exception:
            pass
        return score

    # ------------------------------------------------------------- display
    def format_frame_info(self, frame: dict) -> str:
        """Human-readable frame summary (decoder.py:1121-1187, ASCII tags)."""
        info = (f"Frame #{frame['number']} "
                f"(Type: {self._get_frame_type_name(frame['type'])})")
        info += f"\n  Position: {frame['position']}"
        info += f"\n  Header: {frame['header'][:32]}..."
        ft = frame["type"]
        if ft == 0:
            info += "\n  MAC-RESOURCE - Resource allocation/Start of message"
        elif ft == 1:
            info += "\n  MAC-FRAG - Message fragment"
        elif ft == 2:
            info += "\n  MAC-END - End of message"
        elif ft == 3:
            info += "\n  MAC-BROADCAST - Broadcast information"
        if frame.get("sds_message"):
            info += f"\n  Message: {frame['sds_message']}"
        elif frame.get("decoded_text"):
            info += f"\n  Text: {frame['decoded_text']}"
        if frame.get("encrypted"):
            info += (f"\n  [ENC] Encrypted: Yes "
                     f"({frame.get('encryption_algorithm', 'Unknown')})")
            if frame.get("decrypted"):
                info += "\n  [DEC] Decrypted: Yes"
                if "key_used" in frame:
                    info += f" - {frame['key_used']}"
                if "decrypted_bytes" in frame and not frame.get("sds_message"):
                    info += f"\n  [PAY] Payload (hex): {frame['decrypted_bytes'][:64]}..."
            else:
                info += "\n  [ERR] Decrypted: No"
                if "decryption_error" in frame:
                    info += f" ({frame['decryption_error']})"
        else:
            info += "\n  [CLR] Encrypted: No"
            mac = frame.get("mac_pdu")
            if mac and "data" in mac and not frame.get("sds_message"):
                data = mac["data"]
                if isinstance(data, (bytes, bytearray)) and len(data) > 0:
                    printable = sum(1 for b in data if 32 <= b <= 126 or b in (10, 13))
                    if printable / len(data) > 0.7:
                        try:
                            text = data.decode("latin-1", errors="replace").strip()
                            if text:
                                info += f"\n  [TXT] Data: {text[:80]}"
                            else:
                                info += f"\n  [HEX] Data: {data.hex()[:64]}..."
                        except Exception:
                            info += f"\n  [HEX] Data: {data.hex()[:64]}..."
                    else:
                        info += f"\n  [HEX] Data: {data.hex()[:64]}..."
        if frame.get("is_reassembled"):
            info += "\n  (Reassembled from fragments)"
        if frame.get("has_voice"):
            info += "\n  Contains voice data"
        return info

    def _get_frame_type_name(self, frame_type: int) -> str:
        names = {0: "Broadcast", 1: "Traffic", 2: "Control", 3: "MAC",
                 4: "Supplementary", 5: "Reserved", 6: "Reserved", 7: "Reserved"}
        return names.get(frame_type, f"Unknown({frame_type})")
