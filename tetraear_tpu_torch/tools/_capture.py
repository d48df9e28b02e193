"""What the capture tools share: their source arguments, their
CaptureLoop on --device and the voice attempt on a decoded frame."""

from __future__ import annotations

from datetime import datetime
from typing import Optional

import numpy as np


def add_source_args(ap) -> None:
    """-f/-s, --iq-file, --synthetic (as the JAX tools) and --device."""
    ap.add_argument("-f", "--frequency", type=float, default=392.241)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("--iq-file", type=str, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; without a card the "
                         "tool refuses to run unless given --device cpu)")


def run_id() -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S")


def capture_loop(args, device, *, auto_decrypt: bool, **kwargs):
    """The tools' CaptureLoop: 256 Ki-sample chunks, no AFC, every chunk
    decoded on a replay or synthetic source, the receive on `device`."""
    from tetraear_tpu_torch.ui.capture_loop import CaptureLoop
    from tetraear_tpu_torch.ui.cli import _make_source
    args.gain = "auto"
    return CaptureLoop(_make_source(args), frequency=args.frequency * 1e6,
                       sample_rate=args.sample_rate * 1e6,
                       auto_decrypt=auto_decrypt, chunk_size=256 * 1024,
                       always_decode=bool(args.iq_file or args.synthetic),
                       afc=False, device=device, **kwargs)


def voice_audio(loop, frame) -> Optional[np.ndarray]:
    """The frame's bits through the loop's voice codec; the audio when it
    is not silent, else None."""
    from tetraear_tpu_torch.audio.blocks import block_from_hard_bits
    bits = frame.get("bits")
    vp = loop.voice_processor
    if bits is not None and len(bits) >= 432 and vp and vp.working:
        audio = vp.decode_frame(block_from_hard_bits(bits))
        if audio.size > 0 and float(np.max(np.abs(audio))) > 1e-4:
            return audio
    return None
