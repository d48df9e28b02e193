"""TETRA air-interface constants (ETSI EN 300 392-2) and reference-parity values.

Every constant here is a *behavioral fact* of the TETRA standard or of the
reference implementation (WizzardDr/TetraEar-BladeRF) that the `ref-compat`
profile must reproduce.  Reference provenance is cited as file:line against
that reference's source tree.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Modulation / rates (tetraear/signal/processor.py:30, 51, 245)
# ---------------------------------------------------------------------------
SYMBOL_RATE_HZ = 18_000            # pi/4-DQPSK symbol rate
CHANNEL_BANDWIDTH_HZ = 25_000      # TETRA channel spacing / bandwidth
DEFAULT_SAMPLE_RATE_HZ = 2_400_000  # BladeRF default capture rate
REF_DECIMATION_TARGET_HZ = 240_000  # reference decimates toward this rate
BITS_PER_SYMBOL = 2

# ---------------------------------------------------------------------------
# Frame / slot geometry (tetraear/core/decoder.py:30, core/protocol.py:149-152)
# ---------------------------------------------------------------------------
SYMBOLS_PER_SLOT = 255
BITS_PER_SLOT = 510                # == FRAME_LENGTH in the reference decoder
SLOTS_PER_FRAME = 4
FRAMES_PER_MULTIFRAME = 18
MULTIFRAMES_PER_HYPERFRAME = 60

FRAME_LENGTH_BITS = BITS_PER_SLOT  # the reference calls a slot a "frame"

# Sync pattern search geometry (core/decoder.py:845-877)
SYNC_LEN_BITS = 22
SYNC_TO_FRAME_START_BITS = 216     # frame starts 216 bits before sync hit
SYNC_SKIP_BITS = 250               # greedy search skip after a hit

# ---------------------------------------------------------------------------
# Sync / training sequences
# ---------------------------------------------------------------------------
# 22-bit training sequences used for frame sync (core/decoder.py:196-199).
TS1 = np.array([1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0],
               dtype=np.uint8)
TS2 = np.array([0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0],
               dtype=np.uint8)

# Burst-type detection patterns (core/protocol.py:162-163). SYNC_CONTINUOUS
# equals TS1; SYNC_DISCONTINUOUS is a distinct 22-bit word.
SYNC_CONTINUOUS_DOWNLINK = TS1.copy()
SYNC_DISCONTINUOUS_DOWNLINK = np.array(
    [0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1],
    dtype=np.uint8)

# 31-bit pattern used by the coarse scanner sync probe
# (core/decoder.py:28-29, signal/scanner.py:133-134).
SCANNER_SYNC_PATTERN_31 = np.array(
    [0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0, 0,
     1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0, 0], dtype=np.uint8)

# 14-bit mid-burst training sequences (core/protocol.py:155-159).
TRAINING_SEQUENCES_14 = {
    1: np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1], dtype=np.uint8),
    2: np.array([0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1], dtype=np.uint8),
    3: np.array([0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0], dtype=np.uint8),
}

# ---------------------------------------------------------------------------
# Burst layout within a 510-bit slot (core/protocol.py:277-290)
# ---------------------------------------------------------------------------
BURST_BLOCK1 = (0, 108)        # first data block, bits [0, 108)
BURST_TRAINING = (108, 122)    # 14-bit training field (normal burst)
BURST_TRAINING_SYNC = (108, 130)
BURST_BLOCK2 = (122, 230)      # second data block, bits [122, 230)
BURST_DATA_BITS = 216          # 108 + 108

# ---------------------------------------------------------------------------
# Sync correlation thresholds (core/decoder.py:845-857, 261-281)
# ---------------------------------------------------------------------------
SYNC_THRESHOLDS = (0.90, 0.85, 0.80)
SYNC_ADAPTIVE_FLOOR = 0.75
SYNC_ADAPTIVE_TOLERANCE = 0.02
SYNC_ADAPTIVE_WINDOW = 0.15    # max_corr must be >= threshold - 0.15

# ---------------------------------------------------------------------------
# CRC (core/protocol.py:331-347)
# ---------------------------------------------------------------------------
CRC16_POLY = 0x1021
CRC16_INIT = 0xFFFF
CRC_SOFT_ERROR_BUDGET = 2      # soft-CRC tolerance (protocol.py:315-324)

# ---------------------------------------------------------------------------
# DQPSK decision boundaries (signal/processor.py:152-161)
# phase < -5pi/8 -> 3 ; < -3pi/8 -> 2 ; < 3pi/8 -> 0 ; < 5pi/8 -> 1 ; else 3
# ---------------------------------------------------------------------------
DQPSK_BOUNDARIES = (-5 * np.pi / 8, -3 * np.pi / 8, 3 * np.pi / 8, 5 * np.pi / 8)
# symbol k -> nominal phase transition
DQPSK_PHASES = {0: np.pi / 4, 1: 3 * np.pi / 4, 2: -np.pi / 4, 3: -3 * np.pi / 4}

# ---------------------------------------------------------------------------
# Signal detection gates (ui/modern.py:2000-2018; scanner defaults)
# ---------------------------------------------------------------------------
DETECT_SNR_DB = 15.0
DETECT_PEAK_DBFS = -70.0
DETECT_PEAK_ABOVE_AVG_DB = 3.0
DETECT_LOSS_HYSTERESIS_S = 0.5
SPECTRUM_FFT_SIZE = 2048

# Scanner gates (signal/scanner.py:27-34, 93-94, 143-145, 196)
SCAN_NOISE_FLOOR_DB = -45.0
SCAN_BOTTOM_THRESHOLD_DB = -85.0
SCAN_MOD_CONFIDENCE = 0.4
SCAN_SYNC_CORRELATION = 0.75
SCAN_CHANNEL_STEP_HZ = 25_000.0

# ---------------------------------------------------------------------------
# Voice codec contract (audio/voice.py:77-99, ui/modern.py:2369-2417)
# ---------------------------------------------------------------------------
CODEC_BLOCK_SHORTS = 690
CODEC_BLOCK_BYTES = 1380
CODEC_FRAME_HEADER = 0x6B21
CODEC_SOFT_BIT_MAG = 127
# soft-bit placement ranges within the 690-short block (half-open)
CODEC_BIT_RANGES = ((1, 115), (116, 230), (231, 345), (346, 436))
CODEC_SERIAL_WORDS_PER_SPEECH_FRAME = 138   # BFI + 137
CODEC_PCM_RATE_HZ = 8000

# ---------------------------------------------------------------------------
# Decryption scoring (core/decoder.py:698-786) and validation
# ---------------------------------------------------------------------------
DECRYPT_ACCEPT_SCORE = 80
DECRYPT_EARLY_BREAK_SCORE = 80   # strictly-greater break inside the key loop
VALIDATOR_LOW_DECRYPT_CONFIDENCE = 180
