"""Call-state tracking from real CMCE signalling (etsi profile).

Consumes routed layer-3 results (protocol/layer3.py) and maintains the
call ledger: D-SETUP opens a call, D-TX-GRANTED names the talker,
D-TX-CEASED clears it, D-CONNECT confirms, D-RELEASE/D-DISCONNECT close
with a cause.  Each update emits a CallMetadata record (the schema the
session aggregator / JSONL bridge already speak, protocol/types.py) so
etsi downlink frames carry *authoritative* call facts where the
reference could only pattern-guess
(tetraear/core/protocol.py:597-784: "resource
assignment" = any PDU with a plausible 10-bit channel field, "call
setup" = two SSIs that differ, etc.).

Group calls: the called party of a group call is the layer-2 MAC
address of the D-SETUP (the group SSI the MS listens on), per §14.5.1.1
— so the tracker takes the MAC-RESOURCE address alongside the PDU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tetraear_tpu_torch.protocol import cmce
from tetraear_tpu_torch.protocol.types import CallMetadata

__all__ = ["CallState", "CallTracker"]


@dataclass
class CallState:
    """Ledger entry for one call identifier."""
    call_id: int
    group_ssi: Optional[int] = None       # layer-2 address of the setup
    calling_ssi: Optional[int] = None
    talker_ssi: Optional[int] = None      # current TX-granted party
    simplex_duplex: int = 0
    basic_service_info: int = 0
    priority: int = 0
    is_speech: bool = True
    state: str = "setup"                  # setup|connected|active|released
    disconnect_cause: Optional[int] = None
    allocated_tns: List[int] = field(default_factory=list)  # from MAC
    allocated_carrier: Optional[int] = None
    history: List[str] = field(default_factory=list)


class CallTracker:
    def __init__(self):
        self.calls: Dict[int, CallState] = {}
        self.released: List[CallState] = []

    def _get(self, call_id: int) -> CallState:
        if call_id not in self.calls:
            self.calls[call_id] = CallState(call_id)
        return self.calls[call_id]

    def update(self, pdu, mac_address: Optional[int] = None,
               channel_allocation=None) -> Optional[CallMetadata]:
        """Apply one CMCE PDU; returns a CallMetadata snapshot for
        call-control PDUs, None for non-call PDUs (SDS, status).

        channel_allocation: the MAC-RESOURCE channel-allocation element
        (protocol/mac.ChannelAllocation) that rode the same MAC header —
        it names the timeslot(s)/carrier the call's traffic is assigned
        to (§21.5.2), which is what makes call-following possible."""
        meta = self._update(pdu, mac_address)
        if meta is not None and channel_allocation is not None:
            c = self.calls.get(meta.call_identifier)
            if c is None and self.released:
                c = self.released[-1]
            if c is not None:
                c.allocated_tns = [tn for tn in range(1, 5)
                                   if channel_allocation.timeslots
                                   & (1 << (4 - tn))]
                c.allocated_carrier = channel_allocation.carrier_number
                meta.channel_allocated = (
                    channel_allocation.carrier_number or
                    (c.allocated_tns[0] if c.allocated_tns else None))
        return meta

    def _update(self, pdu, mac_address: Optional[int]
                ) -> Optional[CallMetadata]:
        if isinstance(pdu, cmce.DSetup):
            c = self._get(pdu.call_identifier)
            c.group_ssi = mac_address
            c.calling_ssi = (pdu.calling_party.ssi
                             if pdu.calling_party else None)
            c.simplex_duplex = pdu.simplex_duplex
            c.basic_service_info = pdu.basic_service_info
            c.priority = pdu.call_priority
            c.is_speech = pdu.is_speech
            c.state = "setup"
            c.history.append("D-SETUP")
            return self._meta(c, "call_setup")
        if isinstance(pdu, (cmce.DConnect, cmce.DConnectAck)):
            c = self._get(pdu.call_identifier)
            c.state = "connected"
            c.history.append(pdu.name)
            return self._meta(c, "call_connect")
        if isinstance(pdu, cmce.DTxGranted):
            c = self._get(pdu.call_identifier)
            if pdu.transmitting_party is not None:
                c.talker_ssi = pdu.transmitting_party.ssi
            if pdu.transmission_grant == 1:
                c.state = "active"
            c.history.append("D-TX-GRANTED")
            return self._meta(c, "tx_granted")
        if isinstance(pdu, cmce.DTxCeased):
            c = self._get(pdu.call_identifier)
            c.talker_ssi = None
            c.state = "connected"
            c.history.append("D-TX-CEASED")
            return self._meta(c, "tx_ceased")
        if isinstance(pdu, (cmce.DRelease, cmce.DDisconnect)):
            c = self._get(pdu.call_identifier)
            c.state = "released"
            c.disconnect_cause = pdu.disconnect_cause
            c.history.append(pdu.name)
            self.released.append(self.calls.pop(c.call_id))
            return self._meta(c, "call_release")
        if isinstance(pdu, (cmce.DInfo, cmce.DTxContinue, cmce.DTxWait,
                            cmce.DCallRestore)):
            c = self._get(pdu.call_identifier)
            c.history.append(pdu.name)
            return self._meta(c, "call_update")
        return None

    def _meta(self, c: CallState, kind: str) -> CallMetadata:
        return CallMetadata(
            call_type=kind,
            talkgroup_id=c.group_ssi,
            source_ssi=c.talker_ssi or c.calling_ssi,
            dest_ssi=c.group_ssi,
            channel_allocated=(c.allocated_carrier
                               or (c.allocated_tns[0]
                                   if c.allocated_tns else None)),
            call_identifier=c.call_id,
            call_priority=c.priority,
            duplex_mode="duplex" if c.simplex_duplex else "simplex",
        )

    @property
    def active(self) -> List[CallState]:
        return [c for c in self.calls.values() if c.state != "released"]

    def call_for_tn(self, tn: int) -> Optional[CallState]:
        """The active call whose traffic is allocated to timeslot `tn`
        (call-following: attributes TCH frames to their talkgroup)."""
        for c in self.calls.values():
            if c.state != "released" and tn in c.allocated_tns:
                return c
        return None
