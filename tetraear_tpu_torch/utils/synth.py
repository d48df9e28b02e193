"""IQ synthesis for tests, fixtures, and benchmarks: the reference
package's numpy synthesizer, and the planted-burst wideband and
single-carrier signals the port's tests and chip_smoke.py decode.

The reference repo ships no recorded-IQ regression fixtures (SURVEY.md §4),
so conformance is anchored on synthesized signals with known bits.

Two transition mappings:

* ``pi4``  — true pi/4-DQPSK transitions {0:+pi/4, 1:+3pi/4, 2:-pi/4,
  3:-3pi/4} (ETSI Table 5.1).  NOTE: the reference demodulator's phase bins
  cannot round-trip this mapping (see ops/dqpsk.py quirk note).
* ``ref``  — transitions {0:0, 1:+pi/2, 2:-pi/2, 3:pi}, i.e. the centers of
  the reference's decision bins; a clean signal round-trips exactly through
  the ref-compat chain.  Used for planted-sync end-to-end goldens.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.ops.channelizer import carrier_grid
from tetraear_tpu_torch.ops.crc import _crc_matrix, crc16_bits_arr
from tetraear_tpu_torch.ops.pfb import channel_offsets_hz

_PI4_TRANSITIONS = np.array([np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4])
_REF_TRANSITIONS = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi])


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """Bit pairs (MSB first) -> dibit symbols 0..3."""
    bits = np.asarray(bits).astype(np.uint8) & 1
    assert bits.size % 2 == 0
    return (bits[0::2] << 1) | bits[1::2]


def synthesize_symbol_phasors(symbols: np.ndarray, mapping: str = "pi4",
                              phase0: float = 0.0) -> np.ndarray:
    """Differentially-encoded unit phasors, one per symbol plus the seed."""
    trans = _PI4_TRANSITIONS if mapping == "pi4" else _REF_TRANSITIONS
    phi = phase0 + np.concatenate([[0.0], np.cumsum(trans[np.asarray(symbols)])])
    return np.exp(1j * phi)


def upsample_hold(phasors: np.ndarray, sample_rate: float,
                  symbol_rate: float = C.SYMBOL_RATE_HZ) -> np.ndarray:
    """Nearest-symbol sample-and-hold to the capture rate (handles the
    non-integer 2.4e6/18e3 = 133.33 samples/symbol)."""
    n = int(round(len(phasors) * sample_rate / symbol_rate))
    sym_idx = np.minimum((np.arange(n) * symbol_rate / sample_rate).astype(int),
                         len(phasors) - 1)
    return phasors[sym_idx]


def synthesize_iq(symbols: np.ndarray, sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
                  freq_offset_hz: float = 0.0, snr_db: float | None = None,
                  mapping: str = "pi4", seed: int = 0) -> np.ndarray:
    """Full synthesis: symbols -> phasors -> upsample -> offset -> AWGN."""
    x = upsample_hold(synthesize_symbol_phasors(symbols, mapping), sample_rate)
    if freq_offset_hz:
        t = np.arange(len(x)) / sample_rate
        x = x * np.exp(2j * np.pi * freq_offset_hz * t)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        noise_std = 10 ** (-snr_db / 20) / np.sqrt(2)
        x = x + noise_std * (rng.standard_normal(len(x))
                             + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def make_frame_bits(payload_bits: np.ndarray | None = None,
                    seed: int = 0) -> np.ndarray:
    """A 510-bit slot with TS1 planted at bit offset 216 (the position the
    reference's sync-to-frame-start arithmetic expects, decoder.py:865).

    Burst layout per protocol.py:277-290: data block 1 = bits [0,108),
    training field bits [108,122) (first 14 bits of region), block 2 =
    [122,230).  We put TS1's 22 bits at [216,238) so find_sync lands
    exactly 216 bits into the slot.
    """
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, C.BITS_PER_SLOT).astype(np.uint8)
    if payload_bits is not None:
        payload_bits = np.asarray(payload_bits).astype(np.uint8)
        bits[:min(len(payload_bits), 108)] = payload_bits[:108]
    bits[216:238] = C.TS1
    return bits


def _uint_to_bits(val: int, n: int) -> np.ndarray:
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


def make_mac_resource_frame_bits(payload: bytes, address: int = 0x1234,
                                 encrypted: bool = False, seed: int = 0,
                                 solve_crc: bool = True,
                                 encryption_mode: int | None = None
                                 ) -> np.ndarray:
    """A 510-bit slot carrying a parseable clear MAC-RESOURCE PDU with TS1
    planted at bit offset 216.

    Geometry note (reference quirk, SURVEY.md §7): the sync-to-frame-start
    arithmetic (decoder.py:865) puts TS1 at slot bits [216,238), which
    overlaps the burst's second data block [122,230) — so data bits 202..215
    (the last 14 CRC bits) are *forced* to TS1[0:14].  With ``solve_crc``,
    14 designated payload bits are solved over GF(2) so the computed CRC
    matches those forced bits, yielding a frame that passes the soft-CRC
    gate through the full chain; real reference captures only pass CRC when
    this coincidence happens by chance.
    """
    if len(payload) > 20:
        raise ValueError("payload must fit the 6-bit length field margin")
    if encryption_mode is None:
        encryption_mode = 1 if encrypted else 0
    enc_bits = [(encryption_mode >> 1) & 1, encryption_mode & 1]
    head = np.concatenate([
        [0, 0], enc_bits, [0],
        _uint_to_bits(address, 24), _uint_to_bits(len(payload), 6),
        np.unpackbits(np.frombuffer(payload, np.uint8)) if payload else
        np.zeros(0, np.uint8)])
    return _golden_slot_from_head(head, seed, solve_crc)


def make_mac_end_frame_bits(part: bytes, encrypted: bool = False,
                            seed: int = 0,
                            solve_crc: bool = True) -> np.ndarray:
    """A 510-bit golden slot carrying a MAC-END PDU (type 11) that closes
    a fragmented message: 6-bit length + payload part.  Parser appends
    `part` to the fragment buffer opened by a MAC-RESOURCE and flushes the
    reassembled message (protocol.py:446-594 semantics,
    protocol/parser.py MAC_END branch)."""
    if len(part) > 22:
        raise ValueError("END part must fit the data region")
    enc_bits = [0, 1] if encrypted else [0, 0]
    head = np.concatenate([
        [1, 1], enc_bits, [0], _uint_to_bits(len(part), 6),
        np.unpackbits(np.frombuffer(part, np.uint8)) if part else
        np.zeros(0, np.uint8)])
    return _golden_slot_from_head(head, seed, solve_crc)


def _golden_slot_from_head(head: np.ndarray, seed: int,
                           solve_crc: bool) -> np.ndarray:
    """Shared golden-slot assembly: random filler, GF(2) CRC solve against
    the TS1 overlay, burst-geometry placement (see
    make_mac_resource_frame_bits docstring for the geometry quirk)."""
    rng = np.random.default_rng(seed)
    if head.size > 200:
        raise ValueError("payload too long for a single-slot golden frame")
    data = np.concatenate([head, rng.integers(0, 2, 200 - head.size)
                           .astype(np.uint8)])

    if solve_crc:
        # force crc(data)[2:16] == TS1[0:14] by solving for the last 14
        # filler bits over GF(2)
        free = np.arange(186, 200)
        if head.size > 186:
            free = np.arange(200 - 14, 200)
            if head.size > free[0]:
                raise ValueError("payload leaves no filler bits to solve CRC")
        A, c0 = _crc_matrix(200)
        target = np.asarray(C.TS1[:14], np.uint8)
        base = data.copy()
        base[free] = 0
        resid = (crc16_bits_arr(base)[2:16] ^ target) & 1
        sub = A[2:16][:, free] & 1            # (14, 14) GF(2) system
        x = _gf2_solve(sub, resid)
        if x is None:
            raise RuntimeError("CRC constraint system singular for this seed")
        data = base
        data[free] = x

    crc = crc16_bits_arr(data)
    full = np.concatenate([data, crc])         # 216 data bits incl. CRC
    slot = rng.integers(0, 2, C.BITS_PER_SLOT).astype(np.uint8)
    slot[0:108] = full[0:108]
    slot[108:122] = np.resize(C.TRAINING_SEQUENCES_14[1], 14)
    slot[122:230] = full[108:216]
    # sync overlay: TS1[0:14] == crc[2:16] by construction, so this is a
    # no-op on the data region and only sets the 8 tail bits [230,238)
    slot[216:238] = C.TS1
    return slot


def _gf2_solve(A: np.ndarray, b: np.ndarray):
    """Solve A x = b over GF(2) (square or overdetermined-consistent)."""
    A = (A.copy() & 1).astype(np.uint8)
    b = (b.copy() & 1).astype(np.uint8)
    n_rows, n_cols = A.shape
    x = np.zeros(n_cols, np.uint8)
    pivots = []
    row = 0
    for col in range(n_cols):
        sel = None
        for r in range(row, n_rows):
            if A[r, col]:
                sel = r
                break
        if sel is None:
            continue
        if sel != row:
            A[[row, sel]] = A[[sel, row]]
            b[[row, sel]] = b[[sel, row]]
        for r in range(n_rows):
            if r != row and A[r, col]:
                A[r] ^= A[row]
                b[r] ^= b[row]
        pivots.append((row, col))
        row += 1
        if row == n_rows:
            break
    if any(b[r] for r in range(row, n_rows)):
        return None
    for r, c in pivots:
        x[c] = b[r]
    return x


def make_stream_bits(num_frames: int = 4, lead_bits: int = 64,
                     seed: int = 0, golden: bool = False,
                     payload: bytes = b"HELLO HELLO") -> np.ndarray:
    """Concatenate frames with a random lead-in; sync hits land at
    lead_bits + 216 + k*510.  With ``golden`` the frames are CRC-valid
    MAC-RESOURCE slots (survive the decoder's strict discard)."""
    rng = np.random.default_rng(seed)
    lead = rng.integers(0, 2, lead_bits).astype(np.uint8)
    if golden:
        frames = [make_mac_resource_frame_bits(payload, seed=seed + 1 + k)
                  for k in range(num_frames)]
    else:
        frames = [make_frame_bits(seed=seed + 1 + k) for k in range(num_frames)]
    return np.concatenate([lead] + frames)


def bits_to_iq(bits: np.ndarray, sample_rate: float = C.DEFAULT_SAMPLE_RATE_HZ,
               mapping: str = "ref", freq_offset_hz: float = 0.0,
               snr_db: float | None = None, seed: int = 0) -> np.ndarray:
    """bits -> dibit symbols -> IQ at the capture rate."""
    return synthesize_iq(bits_to_symbols(bits), sample_rate,
                         freq_offset_hz, snr_db, mapping, seed)


def make_mac_block_bits(payload: bytes, address: int = 0x0ABC,
                        total_bits: int = 268, seed: int = 0,
                        encryption_mode: int = 0) -> np.ndarray:
    """A type-1 MAC-RESOURCE bit block for the etsi channel coder
    (SCH/F = 268 bits): header | 24-bit address | 6-bit length |
    payload bytes | random fill.  Unlike make_mac_resource_frame_bits this
    carries no reference-quirk CRC overlay — the etsi chain protects it
    with the real CRC-16 block code (ops/channel_coding.py).

    encryption_mode: the 2-bit MAC header field (0 = clear); callers
    passing an encrypted payload (crypto/tea.TEAEncryptor) set 1-3."""
    rng = np.random.default_rng(seed)
    head = np.concatenate([
        np.zeros(2, np.uint8),                      # pdu type = 00
        _uint_to_bits(encryption_mode, 2),
        np.zeros(1, np.uint8),                      # fill flag
        _uint_to_bits(address, 24), _uint_to_bits(len(payload), 6),
        np.unpackbits(np.frombuffer(payload, np.uint8)) if payload
        else np.zeros(0, np.uint8)])
    if head.size > total_bits:
        raise ValueError("payload too long for the block")
    fill = rng.integers(0, 2, total_bits - head.size).astype(np.uint8)
    return np.concatenate([head, fill])


def make_test_speech(seconds: float = 2.0, fs: int = 8000,
                     seed: int = 1) -> np.ndarray:
    """Voiced-speech-like int16 PCM: a swept pitch-pulse train through
    three formant resonators with syllable-rate amplitude modulation.

    Exercises every stage the real ACELP codec cares about (pitch
    tracking, LP spectrum, gain dynamics) without shipping recorded
    audio; used by the codec tests and `downlink --simulate` voice."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 100 + 40 * (t / max(t[-1], 1e-9))
    phase = np.cumsum(f0) / fs
    exc = (np.diff(np.floor(phase), prepend=0.0) > 0).astype(float)
    exc += 0.02 * rng.standard_normal(n)
    x = exc
    for f, bw in ((700, 130), (1220, 160), (2600, 300)):
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * f / fs
        x = lfilter([1.0], [1.0, -2 * r * np.cos(th), r * r], x)
    x = x / (np.abs(x).max() + 1e-9) * 12000.0
    x *= 0.55 + 0.45 * np.sin(2 * np.pi * 2.5 * t) ** 2
    return x.astype(np.int16)


def planted(carriers: dict, sample_rate_hz: float = 2.4e6,
            num_frames: int = 4) -> np.ndarray:
    """Golden-slot TETRA streams mixed to their offsets: `carriers` maps
    offset_hz -> (stream seed, SDS text payload).  Each carries
    `num_frames` MAC-RESOURCE slots at 13 samples per symbol after the
    receivers' decimation (130 at 2.4 MS/s) — the recipe of the
    reference's tests/unit/test_fused_frontend.py:
    TestDecisionEquivalence._wideband and test_pfb.py:TestPfbFrontend,
    which this is at 2.4 MS/s."""
    from tetraear_tpu_torch.config import ReceiverConfig
    fs = sample_rate_hz
    per_symbol = 13 * ReceiverConfig(sample_rate_hz=fs).decimation_factor
    x = None
    for off, (seed, payload) in carriers.items():
        st = make_stream_bits(num_frames=num_frames, lead_bits=64,
                                 seed=seed, golden=True,
                                 payload=payload.encode()[:20])
        ph = synthesize_symbol_phasors(bits_to_symbols(st),
                                          mapping="ref")
        iq = upsample_hold(ph, fs, fs / per_symbol)
        if x is None:
            x = np.zeros(len(iq), np.complex64)
        t = np.arange(len(x)) / fs
        x += (iq[:len(x)] * np.exp(2j * np.pi * float(off) * t)
              ).astype(np.complex64)
    return x


def planted_scan(offsets_hz=(-300e3, 0.0, 475e3)) -> tuple:
    """The scanner's planted capture at 2.4 MS/s: the i-th offset (a
    multiple of 25 kHz) carries "SCAN CH i" (stream seed i + 1) at
    amplitude 0.1, band-limited to its channel as a transmitter's filter
    limits it (flat to 11 kHz, a cosine taper to 12.5 kHz; the held
    symbols of `planted` alone spread sidelobes over the whole band),
    over complex noise of 0.01 per sample.  In the scanner's 4096-point
    spectra a carrier peaks near -40 dBFS, its neighbours' bins stay
    under the -70 dBFS hot-channel gate and the floor sits near -81
    dBFS, so that the planted channels, and only they, are validated.
    32 frames span one `scan --wideband` capture of 1 << 20 samples.
    Returns (x complex64, {offset_hz: "[TXT] SCAN CH i"})."""
    fs = 2.4e6
    x = None
    for i, off in enumerate(offsets_hz):
        y = planted({0.0: (i + 1, f"SCAN CH {i}")}, fs, num_frames=32)
        f = np.abs(np.fft.fftfreq(len(y), 1.0 / fs))
        mask = 0.5 - 0.5 * np.cos(np.pi * np.clip((12.5e3 - f) / 1.5e3,
                                                  0.0, 1.0))
        y = np.fft.ifft(np.fft.fft(y) * mask) * 0.1
        y = y * np.exp(2j * np.pi * float(off) * np.arange(len(y)) / fs)
        x = y if x is None else x + y
    noise = np.random.default_rng(0).standard_normal((2, len(x)))
    x = x + (0.01 / np.sqrt(2)) * (noise[0] + 1j * noise[1]).astype(
        np.complex64)
    return (x.astype(np.complex64),
            {float(off): f"[TXT] SCAN CH {i}"
             for i, off in enumerate(offsets_hz)})


def planted_wideband(grid_indices, num_carriers: int = 16,
                     sample_rate_hz: float = 2.4e6,
                     num_frames: int = 4) -> tuple:
    """Carrier k (a grid index of `carrier_grid(num_carriers)`) carries
    the SDS text "CARRIER k MSG" (stream seed k).  Returns (x complex64,
    {k: "[TXT] CARRIER k MSG"})."""
    offsets = carrier_grid(num_carriers)
    x = planted({float(offsets[k]): (k, f"CARRIER {k} MSG")
                 for k in grid_indices}, sample_rate_hz, num_frames)
    return x, {k: f"[TXT] CARRIER {k} MSG" for k in grid_indices}


def planted_pfb(offsets_hz=(-50e3, 0.0, 75e3), sample_rate_hz: float = 2.4e6,
                num_frames: int = 4) -> tuple:
    """The full-band filterbank's planted signal (the reference's
    test_pfb.py:TestPfbFrontend recipe): the i-th offset (a multiple of
    25 kHz) carries "PFB CH i+1" (stream seed i+1).  Returns (x
    complex64, {fftfreq channel index: "[TXT] PFB CH i+1"})."""
    num_channels = int(round(sample_rate_hz / 25e3))
    chans = channel_offsets_hz(num_channels, sample_rate_hz)
    carriers = {off: (i + 1, f"PFB CH {i + 1}")
                for i, off in enumerate(offsets_hz)}
    x = planted(carriers, sample_rate_hz, num_frames)
    want = {int(np.argmin(np.abs(chans - off))): f"[TXT] {payload}"
            for off, (_seed, payload) in carriers.items()}
    return x, want


def planted_grid(grid_indices=(3, 8, 12), num_carriers: int = 16,
                 sample_rate_hz: float = 2.4e6, num_frames: int = 4) -> tuple:
    """The real-pair frontend's planted signal on the bench's grid-aligned
    offsets (k - C//2) * 25 kHz, which its mixer table takes (the odd
    multiples of 12.5 kHz of carrier_grid(16) are off that grid): index k
    carries "GRID k MSG" (stream seed k), the length cut to a multiple of
    the table's 96-sample period.  Returns (x complex64, offsets_hz,
    {k: "[TXT] GRID k MSG"})."""
    offsets = ((np.arange(num_carriers) - num_carriers // 2) * 25e3
               ).astype(np.float32)
    x = planted({float(offsets[k]): (k, f"GRID {k} MSG")
                 for k in grid_indices}, sample_rate_hz, num_frames)
    period = int(round(sample_rate_hz / 25e3))
    x = x[:len(x) // period * period]
    return x, offsets, {k: f"[TXT] GRID {k} MSG" for k in grid_indices}


def planted_single(profile: str = "ref-compat", payload: str = "HELLO HELLO",
                   num_frames: int = 4, seed: int = 2,
                   sample_rate_hz: float = 2.4e6) -> tuple:
    """One carrier at 0 Hz of golden MAC-RESOURCE slots carrying the SDS
    text `payload`, as tools/make_fixture.py makes it for each profile:
    the reference's transition mapping at 130 samples per symbol for
    ref-compat and ref-exact, true pi/4-DQPSK at 18 kHz for etsi.
    Returns (x complex64, "[TXT] payload")."""
    etsi = profile == "etsi"
    st = make_stream_bits(num_frames=num_frames, lead_bits=64, seed=seed,
                             golden=True, payload=payload.encode())
    ph = synthesize_symbol_phasors(bits_to_symbols(st),
                                      mapping="pi4" if etsi else "ref")
    x = upsample_hold(ph, sample_rate_hz,
                         18000.0 if etsi else sample_rate_hz / 130.0)
    return x.astype(np.complex64), f"[TXT] {payload}"


def planted_cells(grid_indices=(3, 8, 12), num_carriers: int = 16,
                  slots: int = 72, sample_rate_hz: float = 2.4e6) -> tuple:
    """A wideband capture of ETSI downlink cells (models/downlink.py) on
    carriers `grid_indices` of carrier_grid(num_carriers): cell k has
    MCC 262, MNC 100 + k, colour code 1 + k and SCH/F MAC blocks with the
    text "CELL k MSG" on its TN2 slots, `slots` slots long (72: one
    multiframe, ~1.02 s), each cell from its own stream seed, summed and
    scaled by 1 / the number of cells.  Returns (x complex64,
    {k: (mcc, mnc, colour code, "[TXT] CELL k MSG")})."""
    from tetraear_tpu_torch.models.downlink import (DownlinkConfig,
                                                    DownlinkTransmitter)
    from tetraear_tpu_torch.ops.channelizer import carrier_grid
    offsets = carrier_grid(num_carriers)
    mix = None
    want = {}
    for k in grid_indices:
        cfg = DownlinkConfig(mcc=262, mnc=100 + k, colour_code=1 + k)
        tx = DownlinkTransmitter(cfg)
        pay = {s: make_mac_block_bits(f"CELL {k} MSG".encode(), seed=s)
               for s in range(1, slots, 4)}
        iq = tx.modulate(tx.stream_bits(slots, payloads=pay),
                         sample_rate=sample_rate_hz, seed=k)
        t = np.arange(len(iq)) / sample_rate_hz
        s = iq * np.exp(2j * np.pi * float(offsets[k]) * t)
        mix = s if mix is None else mix[:len(s)] + s[:len(mix)]
        want[k] = (cfg.mcc, cfg.mnc, cfg.colour_code, f"[TXT] CELL {k} MSG")
    return (mix / len(want)).astype(np.complex64), want
