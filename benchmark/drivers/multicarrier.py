"""The wideband decode, driven as `decode --carriers N --conv C` and
`decode --pfb --conv C` drive it (tetraear_tpu_torch/ui/cli.py,
_decode_multicarrier, lines 470-530): `build_frontend` on the carrier
grid or the full band, `MulticarrierDecoder` over its rows, each chunk a
host numpy complex64 array handed to the frontend with the running
`start_index`, then the previous chunk's result to the host decode.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, reference, traffic
from benchmark import golden as G

RESULT_KEYS = ("bits", "sync_corr", "count", "cand_pos", "cand_corr",
               "cand_valid", "frame_bits", "crc_ok")


class System:
    """The program under test: the frontend on the card and the host
    decoder, built as the CLI builds them."""

    def __init__(self, cfg: dict, device):
        from tetraear_tpu_torch.models.multicarrier import (
            MulticarrierDecoder, build_frontend)
        from tetraear_tpu_torch.ops.channelizer import carrier_grid
        fe = cfg["frontend"]
        pfb = fe["kind"] == "pfb"
        self.frontend = build_frontend(
            fe["conv"], device=device, pfb=pfb,
            offsets_hz=carrier_grid(0 if pfb else fe["carriers"]))
        rows = self.frontend.num_channels if pfb else fe["carriers"]
        self.decoder = MulticarrierDecoder(rows, device=device)

    def submit(self, chunk: np.ndarray, start_index: int):
        """Hand a chunk to the frontend; its kernels are queued."""
        return self.frontend(chunk, start_index=start_index)

    def complete(self, result) -> list:
        """The host decode of a submitted chunk: per-row frame lists."""
        return self.decoder.decode(result)


def offsets(cfg: dict) -> np.ndarray:
    """Each receiver row's carrier offset, by the yardstick's own design."""
    return reference.design(cfg)["offsets"]


def make_ring(cfg: dict, params: dict, seed: int, device):
    """The cell's traffic: traffic.py's generator over this configuration's
    rows."""
    return traffic.make_ring(params, offsets(cfg),
                             cfg["frontend"]["sample_rate_hz"], seed, device)


class Control:
    """The precision control in the program's place: the reference with
    its operands rounded to `dtype` (one scale per tensor) demodulates,
    its own stage scores and picks candidates on those bits, and its host
    stage reads each planted slot its sync walk reaches with every bit
    intact as the planted text.  So only the demodulation's numbers can
    tell it from the reference."""

    def __init__(self, cfg: dict, device, ring,
                 dtype=torch.float8_e4m3fn):
        self.d = reference.design(cfg)
        self.device, self.ring, self.dtype = device, ring, dtype

    def submit(self, chunk: np.ndarray, start_index: int) -> dict:
        x = torch.as_tensor(chunk, device=self.device)
        bits, count, _ = reference.demod(
            reference.channelize(x, self.d, operand_dtype=self.dtype))
        bits, count = bits.cpu().numpy(), count.cpu().numpy()
        corr = reference.best_correlation(bits)
        return {"bits": bits, "count": count, "sync_corr": corr,
                **reference.candidates(bits, corr, count, self.d["k"],
                                       self.d["threshold"])}

    def complete(self, result: dict) -> list:
        frames = [[] for _ in result["count"]]
        for row, texts in self.ring.slots.items():
            nbits = 2 * max(int(result["count"][row]) - 1, 0)
            bits = result["bits"][row]
            for pos in reference.walk(
                    result["sync_corr"][row, :max(nbits - 21, 0)]):
                start = pos - G.SYNC_TO_FRAME_START_BITS
                slot = bits[max(start, 0):start + G.BITS_PER_SLOT]
                text = texts.get(slot.tobytes())
                if start >= 0 and text is not None:
                    frames[row].append({"sync_position": pos, "type": 0,
                                        "sds_message": text})
        return frames


def to_host(result) -> dict:
    if isinstance(result, dict):               # the control's, on the host
        return result
    return {k: getattr(result, k).cpu().numpy() for k in RESULT_KEYS}


def check(cfg: dict, ring, samples: list, device) -> tuple:
    """(numbers compared, info) over the sampled chunks: samples holds
    (ring index, host copy of the result, frames) per sampled chunk."""
    d = reference.design(cfg)
    channels = {}
    out = {"demod_gap": 0.0, "flip_share": 0.0, "stage_diff": 0,
           "frames_diff": 0}
    due = flipped = symbols = 0
    for idx, prog, frames in samples:
        if idx not in channels:
            channels[idx] = reference.channelize(
                torch.as_tensor(ring.chunks[idx], device=device), d)
        gap, f, n = compare.demod_gap(channels[idx], prog["bits"],
                                      prog["count"], ring.busy)
        out["demod_gap"] = max(out["demod_gap"], gap)
        flipped, symbols = flipped + f, symbols + n
        out["stage_diff"] += compare.stage_diff(prog, d["k"], d["threshold"])
        wrong, n = compare.frames_diff(prog, frames, ring.slots)
        out["frames_diff"] += wrong
        due += n
    out["flip_share"] = flipped / max(symbols, 1)
    return out, {"chunks_checked": len(samples), "slots_due": due}
