"""The ETSI downlink of one cell's main carrier, driven as `downlink -i
capture.iq` drives it (tetraear_tpu_torch/ui/cli.py, cmd_downlink): a
`DownlinkReceiver` with the CLI's traffic channel and depth, its device
half (`demodulate`: the etsi demod queued on the card) for each chunk,
then the previous chunk's host half (`decode`: the pull, acquisition,
the AACH, the channel decodes and the layer-3 parse).  Each chunk is one
72-slot multiframe of `models/downlink.simulate_multiframe`, its own
cell capture made from its own seeds.

`check` compares each sampled chunk's frames with
benchmark/reference_dl.py:
- `slot_diff` (exact): the slots where the program's frame differs from
  the reference's channel decoding of the program's own soft bits: the
  grid position (index, TN, FN, MN), burst kind, channel, AACH bits,
  the type-1 bits the frame holds and its CRC verdicts; a frame missing
  or extra counts.  Where the two decode a block or an AACH to other
  bits, they agree only if the program's bits are those of a best path
  (codeword) within the float32 rounding of the program's path metrics
  (scores), with the verdict of that path: a float32 decoder may take
  either of two paths that close (reference_dl.path_gap).  The blocks
  and AACHs that agree by this rule alone are counted in the info as
  `ties`.
- `frames_diff` (exact): the frames whose CRC passed but whose content
  is not what was planted (the SYNC PDU's cell, TN, FN and MN; the
  SYSINFO's main carrier, band and location area; the SCH/F block's
  268 bits), and the planted texts and call found missing where every
  slot carrying them passed: each TN2 block's SDS text, the SDS-TL text
  and the group call on a TN3 traffic slot (those two need every TN4
  signalling slot passed).
- `crc_loss`: of the slots whose CRC the reference's own float64 demod
  and decode check, the share that the reference passes and the
  program's frame at the same TN, FN and MN does not.
- `soft_gap`: the demod's precision, the largest over the sampled
  chunks of the median distance between the program's soft-bit pair
  and the reference's float64 demod's, symbol for symbol (both start at
  the chunk's first symbol), less 8 symbols at either end.  The
  program's reading is the two filter designs' difference; a demod that
  rounds its filtered signal to float8 adds more to every symbol.  The
  median, as a mean would, does not follow the few symbols of least
  amplitude, whose phase the two designs read far apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from unittest import mock

import numpy as np
import torch

from benchmark import reference_dl as R
from benchmark import traffic

_WORDS = ("UNIT", "TEAM", "CAR", "BASE", "GATE", "ZONE", "CREW", "POST")
_SYNC_LA = 82          # SYSINFO: main carrier 4..16, band 16..20, LA 82..96


@dataclass
class Ring:
    chunks: list           # R host numpy complex64 arrays, one multiframe
    plans: list            # per chunk: what was planted (see _plan)


def _plan(sim, message: str, slots: int) -> dict:
    from tetraear_tpu_torch.models.downlink import SIM_CALL
    cell = sim.cell
    return {"call": SIM_CALL, "mcc": cell.mcc, "mnc": cell.mnc,
            "cc": cell.colour_code, "la": cell.location_area,
            "carrier": cell.main_carrier, "band": cell.frequency_band,
            "mn": cell.start_mn, "slots": slots, "payloads": sim.payloads,
            "texts": {k: f"{message} #{k}"[:29] for k in sim.payloads
                      if k % 4 == 1},
            "sds_tl": f"{message} via SDS-TL"}


def make_ring(cfg: dict, params: dict, seed: int, device) -> Ring:
    """`ring_chunks` multiframes of `slots` slots, chunk i at
    snr_db[i % len(snr_db)] (dB over the whole 2.4 MS/s band); the seed
    draws each chunk's text, block fill, traffic bits, lead, noise and
    start MN."""
    from tetraear_tpu_torch.models.downlink import simulate_multiframe
    # the card's context first: the ring is host data, and the harness
    # reads the card's memory counters next
    torch.empty(0, device=device)
    rng = traffic.seed_rng(seed)
    slots = int(params["slots"])
    chunks, plans = [], []
    for i in range(int(params["ring_chunks"])):
        message = (f"{_WORDS[rng.integers(len(_WORDS))]} "
                   f"{rng.integers(1000):03d}")
        sim = simulate_multiframe(
            slots, message, float(params["snr_db"][i % len(params["snr_db"])]),
            cfg["traffic_channel"], int(cfg["traffic_depth"]),
            seed=int(rng.integers(1 << 30)),
            start_mn=int(rng.integers(1, 61)))
        chunks.append(sim.iq)
        plans.append(_plan(sim, message, slots))
    return Ring(chunks, plans)


class System:
    """The program under test: a `DownlinkReceiver` built as cmd_downlink
    builds it (no decryption), its offset the configuration's."""

    def __init__(self, cfg: dict, device):
        from tetraear_tpu_torch.models.downlink import DownlinkReceiver
        if not hasattr(DownlinkReceiver, "demodulate"):
            raise SystemExit("DownlinkReceiver has no demodulate / decode "
                             "halves to pipeline")
        self.rx = DownlinkReceiver(traffic_channel=cfg["traffic_channel"],
                                   traffic_depth=int(cfg["traffic_depth"]),
                                   device=device)
        self.offset = cfg["freq_offset_hz"]

    def submit(self, chunk: np.ndarray, start_index: int):
        """The etsi demod of a chunk, queued on the device."""
        return self.rx.demodulate(chunk, self.offset)

    def complete(self, result) -> list:
        """The host half: the chunk's DownlinkFrames."""
        return self.rx.decode(result)


class Control:
    """A control in the program's place: the reference's demod with its
    filtered signal rounded to `signal_dtype` (one scale; None keeps
    float64), and its decode with path metrics in `metric_dtype`.  Its
    frames carry each planted text and the call wherever the slots that
    carry them passed, so only the demod's and the decode's numbers can
    tell it from the reference.  The default, float8 e4m3 in the demod,
    fails `soft_gap`; float64 there and bfloat16 path metrics fail
    `slot_diff` and `crc_loss`."""

    def __init__(self, cfg: dict, device, ring,
                 signal_dtype=torch.float8_e4m3fn,
                 metric_dtype=torch.float64):
        self.device = device
        self.dtype, self.metric_dtype = signal_dtype, metric_dtype
        self.channel = cfg["traffic_channel"]
        self.plans = {id(x): plan for x, plan in zip(ring.chunks,
                                                     ring.plans)}

    def submit(self, chunk: np.ndarray, start_index: int) -> dict:
        x = torch.as_tensor(chunk, device=self.device)
        soft = R.demod(x, self.dtype).reshape(-1)
        return {"soft": soft.cpu().numpy(), "plan": self.plans[id(chunk)]}

    def complete(self, result: dict) -> list:
        slots = R.decode(torch.as_tensor(result["soft"], device=self.device),
                         self.channel, self.metric_dtype)
        frames = [_ref_view(s) for s in slots]
        plan = result["plan"]
        passed = {_key(f, plan): f for f in frames if f["crc_ok"]}
        for k, text in plan["texts"].items():
            if k in passed:
                passed[k]["sds"] = text
        signalling = _signalling(plan)
        if signalling and all(k in passed for k in signalling):
            passed[signalling[-1]]["sds"] = plan["sds_tl"]
            for f in frames:
                if f["tn"] == 3 and f["crc_ok"] is None:
                    f["call"] = plan["call"]
        return frames


FAULTS = ("flip_soft", "colour", "half_slots")


class Faulty:
    """The program with one fault of FAULTS planted where its host half
    reads the demod's result or hands out its frames: one soft bit in
    every 510 turned to the other sign, the cell's colour code off by one
    in its last bit, every second slot's frame dropped."""

    def __init__(self, base: System, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.base, self.fault = base, fault

    def submit(self, x, start_index):
        return self.base.submit(x, start_index)

    def complete(self, res):
        if self.fault == "flip_soft":
            soft = res.soft_bits.clone()
            flat = soft.view(-1)
            flat[300::510] = -torch.sign(flat[300::510])
            return self.base.complete(res._replace(soft_bits=soft))
        if self.fault == "colour":
            from tetraear_tpu_torch.models import downlink
            real = downlink.extended_colour_code
            with mock.patch.object(downlink, "extended_colour_code",
                                   lambda *a: real(*a) ^ 1):
                return self.base.complete(res)
        return [f for f in self.base.complete(res) if f.slot_index % 2 == 0]


def to_host(result) -> dict:
    if isinstance(result, dict):            # a control's, on the host
        return result
    count = int(result.count)
    soft = result.soft_bits[:max(count - 1, 0)].reshape(-1)
    return {"soft": soft.cpu().numpy()}


# ------------------------------------------------------------ the check

def _frame_view(f) -> dict:
    """A DownlinkFrame as the check reads it."""
    meta = f.call_metadata
    return {"index": f.slot_index, "tn": f.tn, "fn": f.fn, "mn": f.mn,
            "burst": f.burst_kind, "channel": f.channel,
            "crc_ok": f.crc_ok, "aach": f.aach.build(),
            "bsch": f.sync_pdu.build() if f.sync_pdu else None,
            "schd": f.sysinfo.build() if f.sysinfo else None,
            "bits": f.mac_bits, "sds": f.sds_message,
            "call": getattr(meta, "call_identifier", None)}


def _ref_view(s: dict) -> dict:
    """A reference slot as the check reads a frame."""
    sb = s["burst"] == "SB"
    if sb:
        crc = s["bsch_ok"] and s["schd_ok"]
    else:
        crc = s.get("ok")
    schd = s.get("schd")
    return {"index": s["index"], "tn": s["tn"], "fn": s["fn"],
            "mn": s["mn"], "burst": s["burst"], "channel": s["channel"],
            "crc_ok": crc, "aach": s["aach"],
            "bsch": s["bsch"] if sb and s["bsch_ok"] else None,
            "schd": (schd if sb and s["schd_ok"]
                     and tuple(schd[:4]) == (1, 0, 0, 0) else None),
            "bits": s.get("bits"), "sds": None, "call": None}


def _view(f) -> dict:
    return f if isinstance(f, dict) else _frame_view(f)


# how each block or AACH compares: the same, alike only by the tie rule,
# or different
SAME, TIE, DIFFERENT = 0, 1, 2


def _same_block(mine, ref_bits, ref_ok, mine_ok, soft, channel, ecc) -> int:
    """A block decoded alike: the same bits and verdict, or a tie within
    the program's float32 rounding (reference_dl.path_gap)."""
    if mine is None:
        return SAME if not ref_ok and not mine_ok else DIFFERENT
    if np.array_equal(mine, ref_bits) and bool(mine_ok) == bool(ref_ok):
        return SAME
    data = torch.as_tensor(np.asarray(mine, np.int64)[None],
                           device=soft.device)
    gap, ok, tol = R.path_gap(soft, channel, ecc, data)
    tie = float(gap[0]) <= float(tol[0]) and bool(ok[0]) == bool(mine_ok)
    return TIE if tie else DIFFERENT


def _same_aach(mine, s) -> int:
    if np.array_equal(mine, s["aach"]):
        return SAME
    scores = R.rm_scores(s["aach_soft"])[0]
    m = int("".join(str(int(b)) for b in mine), 2)
    tol = 2 * 30 * 2.0 ** -24 * float(s["aach_soft"].abs().sum())
    return TIE if float(scores.max() - scores[m]) <= tol else DIFFERENT


def _same_sb(v: dict, s: dict) -> list:
    """A synchronization burst decoded alike: its BSCH, then its SCH/HD,
    which the frame holds only as a SYSINFO PDU."""
    bsch_ok = v["bsch"] is not None
    bsch = _same_block(v["bsch"], s["bsch"], s["bsch_ok"], bsch_ok,
                       s["bsch_soft"], "BSCH", 0)
    if v["schd"] is not None:
        if v["crc_ok"] != bsch_ok:
            return [DIFFERENT]
        return [bsch, _same_block(v["schd"], s["schd"], s["schd_ok"], True,
                                  s["schd_soft"], "SCH/HD", s["ecc"])]
    # no SYSINFO in the frame: its SCH/HD failed, or passed another PDU
    if s["schd_ok"] and tuple(s["schd"][:4]) == (1, 0, 0, 0):
        return [DIFFERENT]
    return [bsch, SAME if v["crc_ok"] == (bsch_ok and s["schd_ok"])
            else DIFFERENT]


def slot_diff(frames: list, ref: list) -> tuple:
    """(slots whose frame differs from the reference's, blocks and AACHs
    of the other slots alike only by the tie rule) (module doc)."""
    views = [_view(f) for f in frames]
    wrong = abs(len(views) - len(ref))
    ties = 0
    for v, s in zip(views, ref):
        if not all(v[k] == s[k] for k in ("index", "tn", "fn", "mn",
                                          "burst", "channel")):
            wrong += 1
            continue
        parts = [_same_aach(v["aach"], s)]
        if s["burst"] == "SB":
            parts += _same_sb(v, s)
        elif "ok" in s:
            channel = "SCH/F" if s["channel"] == "SCH/F" else "STCH"
            parts.append(_same_block(v["bits"], s["bits"], s["ok"],
                                     v["crc_ok"], s["soft"], channel,
                                     s["ecc"]))
        else:
            parts.append(SAME if v["crc_ok"] is None else DIFFERENT)
        if DIFFERENT in parts:
            wrong += 1
        else:
            ties += parts.count(TIE)
    return wrong, ties


def _key(v: dict, plan: dict):
    """The stream slot of the planted multiframe a frame sits at."""
    if v["mn"] != plan["mn"]:
        return None
    k = (v["fn"] - 1) * 4 + v["tn"] - 1
    return k if k < plan["slots"] else None


def _signalling(plan: dict) -> list:
    """The TN4 slots that carry the group call's signalling."""
    return sorted(k for k in plan["payloads"] if k % 4 == 3)


def _field(bits, lo: int, width: int) -> int:
    return int("".join(str(int(b)) for b in bits[lo:lo + width]), 2)


def frames_diff(frames: list, plan: dict) -> int:
    """Passed frames unlike the planted, and planted texts and the call
    missing where their slots passed (module doc)."""
    views = [_view(f) for f in frames]
    wrong = 0
    passed = {}
    for v in views:
        if not v["crc_ok"]:
            continue
        k = _key(v, plan)
        if k is None:
            wrong += 1
            continue
        passed[k] = v
        if v["burst"] == "SB":
            f = R.sync_fields(v["bsch"])
            si = v["schd"]
            wrong += not (
                k % 4 == 0 and si is not None
                and (f["cc"], f["tn"], f["fn"], f["mn"], f["mcc"], f["mnc"])
                == (plan["cc"], v["tn"], v["fn"], v["mn"], plan["mcc"],
                    plan["mnc"])
                and (_field(si, 4, 12), _field(si, 16, 4),
                     _field(si, _SYNC_LA, 14))
                == (plan["carrier"], plan["band"], plan["la"]))
        elif v["channel"] == "SCH/F":
            want = plan["payloads"].get(k)
            traffic_slot = k % 4 == 2 and k // 4 != 17
            if want is None:
                want = np.zeros(268, np.uint8)
            wrong += traffic_slot or not np.array_equal(v["bits"], want)
        else:
            wrong += 1                       # no STCH was planted
    for k, text in plan["texts"].items():
        if k in passed and text not in (passed[k]["sds"] or ""):
            wrong += 1
    signalling = _signalling(plan)
    if signalling and all(k in passed for k in signalling):
        wrong += not any(plan["sds_tl"] in (v["sds"] or "") for v in views)
        wrong += not any(v["call"] == plan["call"] and v["tn"] == 3
                         and v["crc_ok"] is None for v in views)
    return wrong


def _soft_gap(mine: torch.Tensor, ref: torch.Tensor) -> float:
    """Median distance of two chunks' soft-bit pairs, symbol for symbol,
    less 8 symbols at either end."""
    m = min(mine.shape[0], ref.shape[0]) // 2
    d = mine[16:2 * m - 16].to(torch.float64) - ref[16:2 * m - 16]
    return float(d.view(-1, 2).norm(dim=1).median())


def check(cfg: dict, ring, samples: list, device) -> tuple:
    """(numbers compared, info) over the sampled chunks: samples holds
    (ring index, host copy of the result, frames) per sampled chunk."""
    out = {"slot_diff": 0, "frames_diff": 0, "crc_loss": 0.0,
           "soft_gap": 0.0}
    own, own_soft = {}, {}
    lost = checked = ties = 0
    for idx, prog, frames in samples:
        soft = torch.as_tensor(prog["soft"], device=device)
        ref = R.decode(soft, cfg["traffic_channel"])
        wrong, tied = slot_diff(frames, ref)
        out["slot_diff"] += wrong
        ties += tied
        out["frames_diff"] += frames_diff(frames, ring.plans[idx])
        if idx not in own:
            x = torch.as_tensor(ring.chunks[idx], device=device)
            own_soft[idx] = R.demod(x).reshape(-1)
            own[idx] = R.decode(own_soft[idx], cfg["traffic_channel"])
        out["soft_gap"] = max(out["soft_gap"],
                              _soft_gap(soft, own_soft[idx]))
        got = {(v["tn"], v["fn"], v["mn"]): v["crc_ok"]
               for v in map(_view, frames)}
        for s in own[idx]:
            verdict = _ref_view(s)["crc_ok"]
            if verdict is None:
                continue
            checked += 1
            lost += verdict and not got.get((s["tn"], s["fn"], s["mn"]))
    out["crc_loss"] = lost / max(checked, 1)
    return out, {"chunks_checked": len(samples), "slots_checked": checked,
                 "ties": ties}
