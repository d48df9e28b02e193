"""Voice-call accumulation: group per-frame PCM by call/talkgroup into
multi-second clips (behavioral parity with listen_clear.py:65-106).

Rules: a >3 s gap finalizes the previous clip for that call id; a clip is
emitted once it reaches 3 s; finalized clips shorter than 1 s are dropped.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from tetraear_tpu_torch import constants as C


class VoiceAccumulator:
    GAP_S = 3.0
    EMIT_S = 3.0
    MIN_S = 1.0

    def __init__(self, sample_rate: int = C.CODEC_PCM_RATE_HZ,
                 clock=time.time):
        self.sample_rate = sample_rate
        self._clock = clock
        self.calls: Dict[object, List[np.ndarray]] = {}
        self.last_time: Dict[object, float] = {}

    def add(self, call_id, audio: np.ndarray) -> Optional[np.ndarray]:
        """Append a segment; returns a finalized clip when one completes."""
        now = self._clock()
        if call_id not in self.calls:
            self.calls[call_id] = []
            self.last_time[call_id] = now

        if now - self.last_time[call_id] > self.GAP_S and self.calls[call_id]:
            result = self.finalize(call_id)
            self.calls[call_id] = [audio]
            self.last_time[call_id] = now
            return result

        self.calls[call_id].append(audio)
        self.last_time[call_id] = now

        total = sum(len(a) for a in self.calls[call_id])
        if total / self.sample_rate >= self.EMIT_S:
            return self.finalize(call_id)
        return None

    def finalize(self, call_id) -> Optional[np.ndarray]:
        if call_id not in self.calls or not self.calls[call_id]:
            return None
        audio = np.concatenate(self.calls[call_id])
        del self.calls[call_id]
        del self.last_time[call_id]
        return audio if len(audio) / self.sample_rate >= self.MIN_S else None

    def finalize_all(self) -> List[np.ndarray]:
        results = []
        for cid in list(self.calls.keys()):
            a = self.finalize(cid)
            if a is not None:
                results.append(a)
        return results
