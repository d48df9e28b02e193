"""Layer-3 glue: coded MAC block -> MAC PDU walk -> MLE routing ->
typed CMCE/MM PDUs (+ SDS-TL payload decode), with cross-slot TM-SDU
reassembly.

This is the etsi profile's structured alternative to the reference's
heuristic chain (MAC byte-scan -> call-metadata pattern guesses -> SDS
payload sniffing, tetraear/core/protocol.py:349-1018).
models/downlink.py tries this first on every CRC-clean SCH/F or STCH
block and falls back to the reference-parity heuristics when the block
does not validate as real layer-3 (e.g. ref-compat traffic or noise) —
validation is strict by construction: every field read is bounds-checked
(BitCursor raises on underrun), the MAC length indication must be
consistent, and the MLE discriminator must route to a known entity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from tetraear_tpu_torch.protocol import cmce, mac, mle, mm, sds_tl
from tetraear_tpu_torch.protocol.bits import as_bit_array

__all__ = ["Layer3Result", "decode_mac_block", "decode_uplink_block",
           "decode_tm_sdu", "Defragmenter", "describe_pdu"]


@dataclass
class Layer3Result:
    """One MAC PDU and whatever layer 3 it carried."""
    mac_pdu: object                     # MacResource / MacFrag / MacEnd
    pd: Optional[int] = None            # MLE protocol discriminator
    pdu: Optional[object] = None        # typed CMCE/MM PDU or MlePdu
    sds: Optional[sds_tl.SdsTransfer] = None
    fragment: bool = False              # part of a multi-slot TM-SDU

    @property
    def confident(self) -> bool:
        """True when the content routed to a known layer-3 entity —
        the gate models/downlink.py uses before preferring this result
        over the ref-compat heuristics."""
        if self.fragment:
            return True
        if self.pd == mle.PD.MLE:
            return isinstance(self.pdu, mle.DNwrkBroadcast)
        return (self.pd in (mle.PD.MM, mle.PD.CMCE)
                and self.pdu is not None
                and not isinstance(self.pdu, (cmce.GenericCmce,
                                              mm.GenericMm)))

    @property
    def name(self) -> Optional[str]:
        return getattr(self.pdu, "name", None)


def decode_tm_sdu(tm_sdu, uplink: bool = False) -> Layer3Result:
    """Route one reassembled TM-SDU through MLE to its entity codec."""
    pd, body = mle.unwrap_mle(tm_sdu)
    res = Layer3Result(mac_pdu=None, pd=pd)
    if pd == mle.PD.CMCE:
        res.pdu = cmce.parse_cmce(body, uplink=uplink)
        sds_pdu = res.pdu if isinstance(res.pdu, (cmce.DSdsData,
                                                  cmce.USdsData)) else None
        if sds_pdu is not None and sds_pdu.short_data_type == 3 \
                and sds_pdu.data_bits.size >= 8:
            try:
                res.sds = sds_tl.parse_sds_tl(sds_pdu.data_bits)
            except ValueError:
                res.sds = None
    elif pd == mle.PD.MM:
        res.pdu = mm.parse_mm(body)
    elif pd == mle.PD.MLE:
        res.pdu = mle.parse_mle_pdu(body)
    else:
        res.pdu = mle.MlePdu(pd, body)
    return res


def decode_mac_block(bits, uplink: bool = False) -> List[Layer3Result]:
    """One coded-channel block -> routed layer-3 results.

    Raises ``ValueError`` when the block is not parseable as real MAC
    (the caller's cue to fall back to the ref-compat heuristic parser).
    """
    results: List[Layer3Result] = []
    for pdu in mac.parse_mac_block(as_bit_array(bits)):
        if isinstance(pdu, (mac.MacFrag, mac.MacEnd)) or \
                (isinstance(pdu, mac.MacResource) and pdu.fragmented):
            results.append(Layer3Result(mac_pdu=pdu, fragment=True))
            continue
        if pdu.encryption_mode:
            results.append(Layer3Result(mac_pdu=pdu))
            continue
        routed = decode_tm_sdu(pdu.tm_sdu, uplink=uplink)
        routed.mac_pdu = pdu
        results.append(routed)
    return results


def decode_uplink_block(bits, channel: str) -> List[Layer3Result]:
    """Uplink block (MAC-ACCESS on SCH/HU, MAC-DATA on SCH/F) -> routed
    layer-3 results, uplink CMCE registry.  Raises ValueError when the
    block is not real uplink MAC."""
    results: List[Layer3Result] = []
    for pdu in mac.parse_uplink_block(as_bit_array(bits), channel):
        if pdu.encryption_mode:
            results.append(Layer3Result(mac_pdu=pdu))
            continue
        routed = decode_tm_sdu(pdu.tm_sdu, uplink=True)
        routed.mac_pdu = pdu
        results.append(routed)
    return results


class Defragmenter:
    """Cross-slot TM-SDU reassembly (§23.4.2): RESOURCE with the frag
    marker starts a buffer, FRAGs append, END completes.  One SDU can be
    in flight per downlink MAC instance; a new start discards a stale
    buffer (mirrors the reference's fragment-buffer semantics,
    protocol.py:446-594, but at the real MAC layer)."""

    def __init__(self):
        self._start: Optional[mac.MacResource] = None
        self._parts: List[np.ndarray] = []

    @property
    def active(self) -> bool:
        return self._start is not None

    def feed(self, res: Layer3Result,
             uplink: bool = False) -> Optional[Layer3Result]:
        """Feed a fragment result; returns the completed routed result
        when an END closes the SDU, else None."""
        p = res.mac_pdu
        if isinstance(p, mac.MacResource):
            self._start = p
            self._parts = [as_bit_array(p.tm_sdu)]
            return None
        if self._start is None:
            return None                       # orphan fragment
        if isinstance(p, mac.MacFrag):
            self._parts.append(as_bit_array(p.tm_sdu))
            return None
        if isinstance(p, mac.MacEnd):
            sdu = np.concatenate(self._parts + [as_bit_array(p.tm_sdu)])
            start = self._start
            self._start, self._parts = None, []
            try:
                routed = decode_tm_sdu(sdu, uplink=uplink)
            except ValueError:
                return None
            routed.mac_pdu = start
            return routed
        return None


def describe_pdu(result: Layer3Result) -> str:
    """One-line human summary for the CLI/session log."""
    pdu = result.pdu
    if pdu is None:
        m = result.mac_pdu
        if m is not None and getattr(m, "encryption_mode", 0):
            return f"MAC-RESOURCE encrypted (mode {m.encryption_mode})"
        return "MAC fragment" if result.fragment else "MAC PDU"
    bits = []
    name = getattr(pdu, "name", type(pdu).__name__)
    cid = getattr(pdu, "call_identifier", None)
    if cid is not None:
        bits.append(f"call {cid}")
    for attr in ("calling_party", "transmitting_party", "called_party"):
        a = getattr(pdu, attr, None)
        if a is not None:
            bits.append(f"{attr.split('_')[0]} SSI {a.ssi}")
    if result.sds is not None and result.sds.text:
        bits.append(f"text {result.sds.text!r}")
    if getattr(pdu, "precoded_status", None) is not None and \
            "Status" in name:
        bits.append(f"status 0x{pdu.precoded_status:04X}")
    if isinstance(pdu, mle.DNwrkBroadcast) and pdu.neighbours:
        bits.append("neighbours " + ",".join(
            str(n.main_carrier) for n in pdu.neighbours))
    return name + (": " + ", ".join(bits) if bits else "")
